"""The port runs on a machine without JAX: no module of
``smcdet_tpu_torch`` (``studies/`` included) and no line of ``chip_smoke.py``
or the card runners ``tests/torch_synthetic_suites.py``,
``tests/torch_m71_studies.py``, ``tests/torch_m71_fixtures.py`` and
``tests/torch_mcmc_anchor.py`` imports
``jax``, ``flax``, ``optax``, the JAX package ``smcdet_tpu`` or its
``experiments`` scripts (``make_fixture`` among them, which reaches
``smcdet_tpu.ingest``), at any depth of the file
(functions included). And the port's data prep, run without
``--no-download`` on a directory without the survey's files, names the
first missing file and its archive URL, and opens no socket."""

import ast
import socket
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "smcdet_tpu", "experiments",
             "make_fixture")
# the port, its smoke run and the suite runners that run on the card
FILES = sorted((REPO / "smcdet_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "torch_synthetic_suites.py",
    REPO / "tests" / "torch_m71_studies.py",
    REPO / "tests" / "torch_m71_fixtures.py",
    REPO / "tests" / "torch_mcmc_anchor.py"]


def imported_modules(source: str):
    """The top-level names of every module an ``import`` or ``from``
    statement in ``source`` names (relative imports excluded)."""
    names = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return [n.split(".")[0] for n in names]


def test_the_check_sees_nested_and_from_imports():
    src = ("import os\nfrom smcdet_tpu_torch import runner\n"
           "def f():\n    from smcdet_tpu.models import priors\n"
           "    import jax.numpy as jnp\n"
           "    from experiments.m71 import make_fixture\n"
           "    from make_fixture import FLUX_UPPER\n")
    found = imported_modules(src)
    assert [n for n in found if n in FORBIDDEN] == [
        "smcdet_tpu", "jax", "experiments", "make_fixture"]
    assert "smcdet_tpu_torch" in found


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(REPO)) for p in FILES])
def test_no_jax_import(path):
    bad = [n for n in imported_modules(path.read_text()) if n in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_prepare_data_without_files_raises_and_opens_no_socket(tmp_path,
                                                               monkeypatch):
    from smcdet_tpu_torch.data_prep import prepare_data

    opened = []

    class NoSocket(socket.socket):
        def __init__(self, *args, **kwargs):
            opened.append(args)
            raise AssertionError("a socket was opened")

    monkeypatch.setattr(socket, "socket", NoSocket)
    monkeypatch.setattr(socket, "create_connection",
                        lambda *a, **k: opened.append(a))
    with pytest.raises(FileNotFoundError) as e:
        prepare_data.main(["--data-dir", str(tmp_path), "--device", "cpu"])
    assert str(tmp_path / "sdss" / "6895" / "3"
               / "photoField-006895-3.fits") in str(e.value)
    assert ("https://data.sdss.org/sas/dr12/boss/photoObj/301/6895/"
            "photoField-006895-3.fits") in str(e.value)
    assert opened == []
