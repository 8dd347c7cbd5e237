"""Minimal pure-numpy FITS reader/writer (the port's own copy of
``smcdet_tpu/ingest/fits.py``: byte I/O on the host, so it stays numpy; the
writer gives the same bytes as the JAX package's, and each reader reads the
other's files).

What survey ingestion needs:

- primary/IMAGE HDUs with BITPIX in {8, 16, 32, 64, -32, -64},
  BSCALE/BZERO scaling (SDSS frames store unsigned ints via BZERO);
- BINTABLE HDUs with fixed-width columns (L, B, I, J, K, E, D, A and
  repeat counts), returned as a dict of numpy arrays keyed by TTYPE;
- transparent gzip/bz2 decompression by magic bytes;
- an image and binary-table writer (the offline fixture's frames, psField
  and photoField).

FITS structure: 2880-byte header blocks of 80-character ASCII "cards",
terminated by END, then data padded to 2880 bytes, big-endian.
"""

from __future__ import annotations

import bz2
import gzip
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "HDU",
    "read",
    "getdata",
    "getheader",
    "write_image",
    "write_hdus",
    "bintable_hdu_bytes",
    "image_hdu_bytes",
]

BLOCK = 2880
CARD = 80

_BITPIX_DTYPES = {
    8: np.dtype("u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}

# native dtype -> BITPIX, for the writer
_BITPIX_OF = {v.newbyteorder("="): k for k, v in _BITPIX_DTYPES.items()}

# BINTABLE TFORM letter -> (numpy dtype, bytes)
_TFORM_DTYPES = {
    "L": (np.dtype("u1"), 1),  # logical 'T'/'F' bytes
    "B": (np.dtype("u1"), 1),
    "I": (np.dtype(">i2"), 2),
    "J": (np.dtype(">i4"), 4),
    "K": (np.dtype(">i8"), 8),
    "E": (np.dtype(">f4"), 4),
    "D": (np.dtype(">f8"), 8),
    "A": (np.dtype("S1"), 1),
}


@dataclass
class HDU:
    header: dict
    data: object = None  # ndarray for images, dict[str, ndarray] for tables
    name: str = ""
    _raw: bytes = field(default=b"", repr=False)


def _parse_value(text: str):
    text = text.strip()
    if not text:
        return None
    if text.startswith("'"):
        # FITS strings: quoted, trailing blanks insignificant, '' escapes '
        end = 1
        out = []
        while end < len(text):
            if text[end] == "'":
                if end + 1 < len(text) and text[end + 1] == "'":
                    out.append("'")
                    end += 2
                    continue
                break
            out.append(text[end])
            end += 1
        return "".join(out).rstrip()
    if text == "T":
        return True
    if text == "F":
        return False
    try:
        if any(c in text for c in ".EeDd") and not text.lstrip("+-").isdigit():
            return float(text.replace("D", "E").replace("d", "e"))
        return int(text)
    except ValueError:
        return text


def _parse_header(buf: bytes, offset: int):
    """Parse one header at ``offset``; returns (header dict, data offset)."""
    header: dict = {}
    pos = offset
    while True:
        block = buf[pos : pos + BLOCK]
        if len(block) < BLOCK:
            raise ValueError("truncated FITS header")
        done = False
        for i in range(0, BLOCK, CARD):
            card = block[i : i + CARD].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if not key or key in ("COMMENT", "HISTORY"):
                continue
            if card[8:10] != "= ":
                continue
            body = card[10:]
            # strip inline comment (outside quoted strings)
            if body.lstrip().startswith("'"):
                q = body.find("'")
                q2 = q + 1
                while q2 < len(body):
                    if body[q2] == "'":
                        if q2 + 1 < len(body) and body[q2 + 1] == "'":
                            q2 += 2
                            continue
                        break
                    q2 += 1
                value_text = body[: q2 + 1]
            else:
                slash = body.find("/")
                value_text = body if slash < 0 else body[:slash]
            header[key] = _parse_value(value_text)
        pos += BLOCK
        if done:
            break
    return header, pos


def _data_size(header: dict) -> int:
    naxis = header.get("NAXIS", 0)
    if naxis == 0:
        return 0
    size = abs(header["BITPIX"]) // 8
    for i in range(1, naxis + 1):
        size *= header[f"NAXIS{i}"]
    # PCOUNT heap bytes (BINTABLE variable arrays) follow the main table
    size = size * header.get("GCOUNT", 1) + header.get("PCOUNT", 0) * (
        1 if header.get("XTENSION", "").startswith("BINTABLE") else 0
    )
    return size


def _parse_image(header: dict, raw: bytes):
    naxis = header.get("NAXIS", 0)
    if naxis == 0:
        return None
    shape = tuple(
        header[f"NAXIS{i}"] for i in range(naxis, 0, -1)
    )  # FITS axes are fastest-first
    dtype = _BITPIX_DTYPES[header["BITPIX"]]
    n = int(np.prod(shape))
    arr = np.frombuffer(raw[: n * dtype.itemsize], dtype=dtype).reshape(shape)
    bscale = header.get("BSCALE", 1)
    bzero = header.get("BZERO", 0)
    if bscale != 1 or bzero != 0:
        # Promote before scaling (the unsigned-int idiom BZERO=2^15/2^31
        # overflows the storage dtype); keep integers integral.
        if isinstance(bscale, int) and isinstance(bzero, int):
            arr = arr.astype(np.int64) * bscale + bzero
        else:
            arr = arr.astype(np.float64) * bscale + bzero
    else:
        arr = arr.astype(dtype.newbyteorder("="))
    return arr


def _parse_tform(tform: str):
    tform = tform.strip()
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    repeat = int(tform[:i]) if i else 1
    code = tform[i]
    if code in ("P", "Q"):
        raise NotImplementedError("variable-length array columns")
    dtype, size = _TFORM_DTYPES[code]
    return repeat, code, dtype, size


def _parse_bintable(header: dict, raw: bytes):
    nrows = header["NAXIS2"]
    rowbytes = header["NAXIS1"]
    tfields = header["TFIELDS"]
    cols = {}
    offset = 0
    table = np.frombuffer(raw[: nrows * rowbytes], dtype="u1").reshape(
        nrows, rowbytes
    )
    for f in range(1, tfields + 1):
        name = str(header.get(f"TTYPE{f}", f"col{f}")).strip()
        repeat, code, dtype, size = _parse_tform(str(header[f"TFORM{f}"]))
        nbytes = repeat * size
        chunk = table[:, offset : offset + nbytes]
        if code == "A":
            vals = chunk.tobytes()
            col = np.array(
                [
                    vals[r * nbytes : (r + 1) * nbytes]
                    .decode("ascii", errors="replace")
                    .rstrip()
                    for r in range(nrows)
                ]
            )
        else:
            col = np.frombuffer(chunk.tobytes(), dtype=dtype).reshape(
                nrows, repeat
            )
            if code == "L":
                col = col == ord("T")
            col = col.astype(col.dtype.newbyteorder("="))
            if repeat == 1:
                col = col[:, 0]
        # TDIMn multidimensional shapes, e.g. '(6,5)'
        tdim = header.get(f"TDIM{f}")
        if tdim and code != "A":
            dims = tuple(
                int(d) for d in str(tdim).strip("() ").split(",")
            )[::-1]
            col = col.reshape((nrows,) + dims)
        cols[name] = col
        # case-insensitive convenience (SDSS headers mix cases)
        cols.setdefault(name.lower(), cols[name])
        offset += nbytes
    return cols


def _decompress(buf: bytes) -> bytes:
    if buf[:2] == b"\x1f\x8b":
        return gzip.decompress(buf)
    if buf[:3] == b"BZh":
        return bz2.decompress(buf)
    return buf


def read(path_or_bytes) -> list[HDU]:
    """Read all HDUs of a FITS file (optionally gzip/bz2 compressed)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    buf = _decompress(buf)

    hdus = []
    pos = 0
    while pos + BLOCK <= len(buf):
        header, data_pos = _parse_header(buf, pos)
        size = _data_size(header)
        raw = buf[data_pos : data_pos + size]
        xt = str(header.get("XTENSION", "")).strip()
        if xt.startswith("BINTABLE"):
            data = _parse_bintable(header, raw)
        else:
            data = _parse_image(header, raw)
        hdus.append(
            HDU(
                header=header,
                data=data,
                name=str(header.get("EXTNAME", "")).strip(),
            )
        )
        pos = data_pos + ((size + BLOCK - 1) // BLOCK) * BLOCK
        if pos >= len(buf):
            break
    return hdus


def getdata(path, hdu: int = 0):
    """Data of HDU ``hdu`` (astropy ``fits.getdata`` equivalent)."""
    return read(path)[hdu].data


def getheader(path, hdu: int = 0) -> dict:
    return read(path)[hdu].header


# ----------------------------------------------------------------------
# Writer
# ----------------------------------------------------------------------
def _format_card(key: str, value) -> bytes:
    if isinstance(value, bool):
        val = "T" if value else "F"
        card = f"{key:<8}= {val:>20}"
    elif isinstance(value, (int, np.integer)):
        card = f"{key:<8}= {value:>20d}"
    elif isinstance(value, (float, np.floating)):
        card = f"{key:<8}= {value:>20.13E}"
    else:
        card = f"{key:<8}= '{str(value):<8}'"
    return card.ljust(CARD).encode("ascii")


def write_image(path, array, header_extras: dict | None = None):
    """Write a single-HDU FITS image (big-endian, float32/float64/ints)."""
    array = np.asarray(array)
    bitpix = _BITPIX_OF[array.dtype.newbyteorder("=")]
    cards = [
        _format_card("SIMPLE", True),
        _format_card("BITPIX", bitpix),
        _format_card("NAXIS", array.ndim),
    ]
    for i, dim in enumerate(reversed(array.shape), start=1):
        cards.append(_format_card(f"NAXIS{i}", dim))
    for k, v in (header_extras or {}).items():
        cards.append(_format_card(k[:8].upper(), v))
    cards.append(b"END".ljust(CARD))
    header = b"".join(cards)
    header += b" " * (-len(header) % BLOCK)

    data = array.astype(array.dtype.newbyteorder(">")).tobytes()
    data += b"\x00" * (-len(data) % BLOCK)
    with open(path, "wb") as f:
        f.write(header + data)


def image_hdu_bytes(array=None, header_extras=None, primary=False) -> bytes:
    """Serialized IMAGE (or primary) HDU; ``array=None`` -> headers only."""
    cards = []
    if primary:
        cards.append(_format_card("SIMPLE", True))
    else:
        cards.append(_format_card("XTENSION", "IMAGE"))
    if array is None:
        cards += [_format_card("BITPIX", 8), _format_card("NAXIS", 0)]
        if not primary:
            cards += [_format_card("PCOUNT", 0), _format_card("GCOUNT", 1)]
        data = b""
    else:
        array = np.asarray(array)
        bitpix = _BITPIX_OF[array.dtype.newbyteorder("=")]
        cards += [
            _format_card("BITPIX", bitpix),
            _format_card("NAXIS", array.ndim),
        ]
        for i, dim in enumerate(reversed(array.shape), start=1):
            cards.append(_format_card(f"NAXIS{i}", dim))
        if not primary:
            cards += [_format_card("PCOUNT", 0), _format_card("GCOUNT", 1)]
        data = array.astype(array.dtype.newbyteorder(">")).tobytes()
    for k, v in (header_extras or {}).items():
        cards.append(_format_card(k[:8].upper(), v))
    cards.append(b"END".ljust(CARD))
    header = b"".join(cards)
    header += b" " * (-len(header) % BLOCK)
    data += b"\x00" * (-len(data) % BLOCK)
    return header + data


_TFORM_CODES = {
    np.dtype("u1"): "B",
    np.dtype("i2"): "I",
    np.dtype("i4"): "J",
    np.dtype("i8"): "K",
    np.dtype("f4"): "E",
    np.dtype("f8"): "D",
}


def bintable_hdu_bytes(columns: dict) -> bytes:
    """Serialized BINTABLE HDU from ``{name: array}`` (first axis = rows;
    trailing axes become repeat counts with TDIM)."""
    names = list(columns)
    arrays = [np.asarray(columns[n]) for n in names]
    nrows = arrays[0].shape[0]

    tforms, tdims, col_bytes = [], [], []
    for arr in arrays:
        assert arr.shape[0] == nrows
        base = arr.dtype.newbyteorder("=")
        code = _TFORM_CODES[base]
        repeat = int(np.prod(arr.shape[1:])) if arr.ndim > 1 else 1
        tforms.append(f"{repeat}{code}")
        tdims.append(
            "(" + ",".join(str(s) for s in arr.shape[1:][::-1]) + ")"
            if arr.ndim > 2
            else None
        )
        col_bytes.append(
            arr.reshape(nrows, -1).astype(base.newbyteorder(">")).tobytes()
        )
    widths = [len(c) // nrows for c in col_bytes]
    rowbytes = sum(widths)

    cards = [
        _format_card("XTENSION", "BINTABLE"),
        _format_card("BITPIX", 8),
        _format_card("NAXIS", 2),
        _format_card("NAXIS1", rowbytes),
        _format_card("NAXIS2", nrows),
        _format_card("PCOUNT", 0),
        _format_card("GCOUNT", 1),
        _format_card("TFIELDS", len(names)),
    ]
    for i, (name, tform, tdim) in enumerate(
        zip(names, tforms, tdims), start=1
    ):
        cards.append(_format_card(f"TTYPE{i}", name))
        cards.append(_format_card(f"TFORM{i}", tform))
        if tdim:
            cards.append(_format_card(f"TDIM{i}", tdim))
    cards.append(b"END".ljust(CARD))
    header = b"".join(cards)
    header += b" " * (-len(header) % BLOCK)

    rows = b"".join(
        b"".join(
            col[r * w : (r + 1) * w] for col, w in zip(col_bytes, widths)
        )
        for r in range(nrows)
    )
    rows += b"\x00" * (-len(rows) % BLOCK)
    return header + rows


def write_hdus(path, hdu_bytes_list):
    """Concatenate pre-serialized HDUs into a FITS file."""
    with open(path, "wb") as f:
        for b in hdu_bytes_list:
            f.write(b)
