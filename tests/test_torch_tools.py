"""The host-side tools around the port's kernels, on the CPU: the build of a
variant library (``_build.build(source_flags=...)``, against a stand-in for
``nvcc``), the SASS reader (``tests/torch_sass.py``) on text in
``cuobjdump -sass``'s format, the kernel comparison's arguments, kernel ids
and SASS verdict (``tests/torch_kernel_compare.py``), the lane-count variant
(``tests/torch_lane_variant.py``),
``chip_smoke.launch_agreement``'s bars and ``chip_smoke.print_paths``'
ranking."""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_kernel_compare as compare
import torch_lane_variant as variant
import torch_sass as sass
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

import chip_smoke
from smcdet_tpu_torch import _build

ROOT_PKG = Path(variant.__file__).resolve().parents[1] / "smcdet_tpu_torch"

SASS = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

\tcode for sm_90a
\t\tFunction : _Z3fooPfi
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
    /*0000*/       LDC R1, c[0x0][0x28] ;              /* 0x00000a00ff017b82 */
                                                       /* 0x000fe40000000800 */
    /*0010*/       IMAD.MOV.U32 R2, RZ, RZ, 0x3f800000 ;
.L_x_{a}:
    /*0020*/       FADD R2, R2, 1 ;                    /* 0x3f80000002027421 */
.L_x_{b}:
    /*0030*/       FMUL R3, R3, R2 ;
    /*0040*/   @P0 BRA `(.L_x_{b}) ;
    /*0050*/       BSSY B0, `(.L_x_{c}) ;
    /*0060*/  @!P1 BRA `(.L_x_{a}) ;
.L_x_{c}:
    /*0070*/       EXIT ;
.L_x_{d}:
    /*0080*/       BRA `(.L_x_{d});
"""

ADDRESSED = """
\t\tFunction : _Z3barv
        /*0000*/                   MOV R2, RZ ;
        /*0010*/                   FADD R2, R2, 1 ;
        /*0020*/              @P0 BRA 0x10 ;
        /*0030*/                   EXIT ;
"""


def test_sass_functions_strip_addresses_and_renumber_labels():
    body = sass.functions(SASS.format(a=1, b=0, c=2, d=3))["_Z3fooPfi"]
    assert body == [
        "LDC R1, c[0x0][0x28]", "IMAD.MOV.U32 R2, RZ, RZ, 0x3f800000",
        "L0:", "FADD R2, R2, 1", "L1:", "FMUL R3, R3, R2", "@P0 BRA `(L1)",
        "BSSY B0, `(L2)", "@!P1 BRA `(L0)", "L2:", "EXIT", "L3:",
        "BRA `(L3)"]
    assert sass.instructions(body) == 9


def test_sass_same_code_with_other_label_numbers_compares_equal():
    one = sass.functions(SASS.format(a=1, b=0, c=2, d=3))
    other = sass.functions(SASS.format(a=17, b=40, c=41, d=9))
    assert one == other
    changed = sass.functions(
        SASS.format(a=1, b=0, c=2, d=3).replace("FMUL", "FADD"))
    assert changed != one


def test_sass_names_drop_the_anonymous_namespace_hash():
    name = ("_ZN44_GLOBAL__N__{}_11_chain_k5_cu_{}"
            "15chain_k5_kernelILi0EEEvPKfPfii")
    one = name.format("4ae64a37", "2fef6297")
    other = name.format("0badc0de", "12345678")
    assert sass.stable_name(one) == sass.stable_name(other) == (
        "_ZN_GLOBAL__N_15chain_k5_kernelILi0EEEvPKfPfii")
    assert chip_smoke._kernel_label(sass.stable_name(one)) == (
        "chain_k5_kernel<0>")
    text = SASS.replace("_Z3fooPfi", one).format(a=1, b=0, c=2, d=3)
    assert list(sass.functions(text)) == [sass.stable_name(other)]
    assert sass.stable_name("_Z3fooPfi") == "_Z3fooPfi"


@pytest.mark.parametrize("mangled,label", [
    ("_ZN51_GLOBAL__N__7c0c995a_18_mala_sweep_wide_cu_d86c9e5826mala_sweep_"
     "k4g_kernel_wideILi1ELi2ELb0EEEv14GenericBuffersiiiii13GenericParams",
     "mala_sweep_k4g_kernel_wide<1,2,0>"),
    ("_ZN49_GLOBAL__N__22055e90_16_mh_sweep_wide_cu_f9d0bc0724mh_sweep_k2g_"
     "kernel_wideILi1ELi2EEEv14GenericBuffersiiiii13GenericParams",
     "mh_sweep_k2g_kernel_wide<1,2>"),
    ("_ZN_GLOBAL__N_21mala_sweep_k4g_kernelILi1024ELi32ELi0ELi1ELb1EEEv14"
     "GenericBuffersiiiii13GenericParams",
     "mala_sweep_k4g_kernel<1024,32,0,1,1>")])
def test_kernel_labels_of_class_and_wide_kernels(mangled, label):
    """A pixel-class kernel and a wide route's kernel, as ``nvcc -Xptxas
    -v`` names them (with the anonymous namespace's hash) or as
    ``torch_sass.stable_name`` leaves them, get their ``name<args>`` label,
    whose kernel id is their kernel's."""
    assert chip_smoke._kernel_label(mangled) == label
    assert chip_smoke._kernel_label(sass.stable_name(mangled)) == label
    assert chip_smoke.kernel_id(label) == (
        "K4g" if label.startswith("mala") else "K2g")


def test_sass_loops_and_loop_sizes():
    body = sass.functions(SASS.format(a=1, b=0, c=2, d=3))["_Z3fooPfi"]
    # the outer loop FADD .. @!P1 BRA (5 instructions), the inner FMUL ..
    # @P0 BRA (2), the self-loop (1); the forward BSSY is no branch
    assert [n for _, _, n in sass.loops(body)] == [5, 2, 1]
    assert sass.loop_sizes(body) == (5, 2)


def test_sass_branch_to_an_address_becomes_a_label():
    body = sass.functions(ADDRESSED)["_Z3barv"]
    assert body == ["MOV R2, RZ", "L0:", "FADD R2, R2, 1", "@P0 BRA L0",
                    "EXIT"]
    assert sass.loop_sizes(body) == (2, 0)
    assert sass.loop_sizes(["MOV R2, RZ", "EXIT"]) == (0, 0)


@pytest.mark.parametrize("name, kid", [
    ("mh_sweep_k2_kernel<8,8,4,0,1>", "K1"),
    ("mh_sweep_k2_kernel<8,8,8,0,1>", "K1"),
    ("void (anonymous namespace)::mh_sweep_k2_kernel<8, 8, 4, 0, 1>"
     "(long const*, float const*)", "K1"),
    ("mh_sweep_k2_kernel<8,8,4,1,0>", "K2"),
    ("mh_sweep_k2_kernel<16,16,16,0,1>", "K2"),
    ("mh_sweep_k3_kernel<16,8,16>", "K3"),
    ("mala_sweep_k4_kernel<8,8,4,0,0,1>", "K4"),
    ("chain_k5_kernel<2>", "K5"),
    ("mh_sweep_k2g_kernel<1024,32,0,1>", "K2g"),
    ("mh_sweep_k2g_kernel_wide<1,0>", "K2g"),
    ("mh_sweep_k3g_kernel<512,32,0,1>", "K3g"),
    ("mh_sweep_k3g_kernel_wide<0,2>", "K3g"),
    ("mala_sweep_k4g_kernel<0,1,true>", "K4g"),
    ("mala_sweep_k4g_kernel<1024,32,0,1,true>", "K4g"),
    ("mala_sweep_k4g_kernel_wide<1,2,false>", "K4g"),
    ("at::native::vectorized_elementwise_kernel<4>", None)])
def test_kernel_ids_of_kernel_names(name, kid):
    assert chip_smoke.kernel_id(name) == kid


def test_compare_names_an_earlier_checkouts_thread_per_particle_k1():
    assert compare.kernel_id("mh_sweep_kernel<8,8,6>") == "K1"
    assert chip_smoke.kernel_id("mh_sweep_kernel<8,8,6>") is None
    for name in ("mh_sweep_k2_kernel<8,8,4,0,1>",
                 "mh_sweep_k3_kernel<16,8,16>",
                 "at::native::vectorized_elementwise_kernel<4>"):
        assert compare.kernel_id(name) == chip_smoke.kernel_id(name)


def test_compare_takes_the_kernels_to_compare():
    opts = compare.parse_args(["--parent", "x", "--kernel", "K1", "K4"])
    assert opts.kernel == ["K1", "K4"] and opts.parent == Path("x")
    assert not opts.end_to_end
    with pytest.raises(SystemExit):
        compare.parse_args(["--parent", "x", "--kernel", "K9"])
    with pytest.raises(SystemExit):
        compare.parse_args(["--parent", "x"])
    assert set(compare.SHAPES) | {"K5"} == set(compare.KERNELS)
    assert set(compare.END_TO_END) == set(compare.SHAPES)


def test_compare_fails_only_on_kernels_it_was_not_asked_about():
    body = sass.functions(SASS.format(a=1, b=0, c=2, d=3))["_Z3fooPfi"]
    other = sass.functions(SASS.format(a=1, b=0, c=2, d=3).replace(
        "FMUL", "FADD"))["_Z3fooPfi"]
    names = {"k1": "mh_sweep_k2_kernel<8,8,4,0,1>",
             "k2": "mh_sweep_k2_kernel<8,8,4,1,0>",
             "k4": "mala_sweep_k4_kernel<8,8,4,0,0,1>"}
    earlier = {names["k1"]: body, names["k2"]: body, names["k4"]: body}

    def differ(new, asked):
        return compare.kernels_that_differ(earlier, new, asked,
                                           lambda n: n, chip_smoke.kernel_id)

    assert differ(dict(earlier), {"K1"}) == []
    changed = dict(earlier, **{names["k1"]: other, names["k4"]: other})
    assert differ(changed, {"K1", "K4"}) == []
    assert differ(changed, {"K4"}) == [names["k1"]]
    assert differ(changed, {"K2"}) == sorted([names["k1"], names["k4"]])
    # a kernel one build lacks differs too
    fewer = {n: b for n, b in earlier.items() if n != names["k2"]}
    assert differ(fewer, {"K1", "K4"}) == [names["k2"]]
    assert differ(fewer, {"K2"}) == []
    # a kernel added since (an id the earlier build has no function of)
    # does not, unlike a new instantiation of a kernel the earlier one has
    more = dict(earlier, **{"mh_sweep_k3g_kernel<0,1>": body})
    assert differ(more, {"K1"}) == []
    more = dict(earlier, **{"mh_sweep_k2_kernel<16,16,16,0,1>": body})
    assert differ(more, {"K1"}) == ["mh_sweep_k2_kernel<16,16,16,0,1>"]


def test_k3_lanes_fit_the_kernels_layout():
    """K3's ``constexpr int kLanes*`` lines, read by the lane variant's
    parser: 16 lanes on the joined 16x8 tile and 32 on 16x16 (K4's bridge
    picks), each dividing the tile's pixels and a warp, at least the three
    proposal lanes, dividing a row or a multiple of it, and at most 32
    pixels a lane (one bit each in the even-child mask)."""
    lanes = variant.k3_source_lanes()
    assert lanes == {(16, 8): 16, (16, 16): 32}
    for (h, w), L in lanes.items():
        hw = h * w
        assert hw % L == 0 and 32 % L == 0 and L >= 4
        assert w % L == 0 or L % w == 0
        assert hw // L <= 32


def test_lane_variant_sets_k3_lanes(tmp_path):
    """``--k3`` changes K3's constants in the copy and nothing else of the
    kernels' sources."""
    pkg = variant.write_variant(tmp_path, k3={"bridge16x8": 8,
                                              "bridge16x16": 16})
    root = Path(variant.__file__).resolve().parents[1] / "smcdet_tpu_torch"
    assert variant.k3_source_lanes(pkg) == {(16, 8): 8, (16, 16): 16}
    for src in sorted((root / "csrc").iterdir()):
        if src.name != "mh_sweep_k3.cu":
            assert (pkg / "csrc" / src.name).read_text() == src.read_text()
    assert variant.k4_source_lanes(pkg) == variant.k4_source_lanes()
    with pytest.raises(SystemExit):
        variant.main([str(tmp_path), "--k3", "bridge8x8=4"])


def test_generic_lanes_fit_the_kernels_layout():
    """The pixel classes' ``constexpr int kLanesTile<CAP>`` and
    ``kLanesBridge<CAP>`` lines (``csrc/mh_sweep_classes.cuh``, the one
    place that sets them for K2g, K3g and K4g), read by the lane variant's
    parser, are ``ops/mh_sweep.py:GENERIC_CLASS_LANES`` (the plain
    versions' lane order); each divides a warp and its class, holds the
    three proposal lanes and leaves at most 32 pixels a lane up to 1024
    pixels (a lane's registers; the larger classes keep their caches in
    shared memory). ``generic_lanes`` and ``k4_lanes`` take them (32 on the
    wide route)."""
    from smcdet_tpu_torch.models.imaging import ImageModel
    from smcdet_tpu_torch.models.psf import GaussianPSF
    from smcdet_tpu_torch.ops import mala_sweep, mh_sweep

    lanes = variant.generic_source_lanes()
    assert lanes == mh_sweep.GENERIC_CLASS_LANES
    assert {cap for cap, _ in lanes} == set(variant.GENERIC_CLASSES)
    for (cap, bridge), L in lanes.items():
        assert 32 % L == 0 and L >= 4 and cap % L == 0
        assert cap // L <= 32 or cap > 1024
    for src in sorted((ROOT_PKG / "csrc").iterdir()):
        if src.name != variant.GENERIC_SOURCE:
            assert not [name for name in variant._constants(src.read_text())
                        if re.fullmatch(r"kLanes(Tile|Bridge)\d+", name)]
    model = ImageModel(8, 8, 4, GaussianPSF(1.0, device="cpu"),
                       noise="poisson", background=100.0, device="cpu")
    for (h, w) in ((8, 8), (16, 8), (16, 16), (32, 16), (32, 32), (24, 24),
                   (48, 32)):
        for bridge in (False, True):
            m = model.with_shape(h, w)
            cap = mh_sweep.generic_pixel_class(h * w)
            want = 32 if cap is None else lanes[cap, bridge]
            assert mh_sweep.generic_lanes(m, 40, bridge) == want
            assert mala_sweep.k4_lanes(m, bridge, 40) == want
    wide = (ROOT_PKG / "csrc" / "mala_sweep_wide.cu").read_text()
    assert "const int lane = threadIdx.x % 32;" in wide


def test_lane_variant_sets_generic_lanes(tmp_path):
    """``--k2g`` and ``--k3g`` change the class lanes of the tile target
    and the bridge in the copy's header and its ``GENERIC_CLASS_LANES``,
    ``--set`` any other constant of a source (here K3g's ``kUnroll`` and K2g's
    ``kMinBlocks``), ``--contract`` the copy's ``SOURCE_FLAGS``; nothing
    else of the kernels' sources changes."""
    import importlib.util

    pkg = variant.write_variant(
        tmp_path, k2g={512: 16, 64: 8}, k3g={512: 16},
        contract=["mh_sweep_k3g.cu"],
        constants=[("mh_sweep_k2g.cu", "kMinBlocks", 3),
                   ("mh_sweep_k3g.cu", "kUnroll", 8)])
    want = dict(variant.generic_source_lanes())
    want.update({(512, False): 16, (64, False): 8, (512, True): 16})
    assert variant.generic_source_lanes(pkg) == want
    spec = importlib.util.spec_from_file_location(
        "variant_mh_sweep", pkg / "ops" / "mh_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.GENERIC_CLASS_LANES == want
    k3g = (pkg / "csrc" / "mh_sweep_k3g.cu").read_text()
    assert "constexpr int kUnroll = 8;" in k3g
    k2g = variant._constants((pkg / "csrc" / "mh_sweep_k2g.cu").read_text())
    assert k2g["kMinBlocks"] == 3
    spec = importlib.util.spec_from_file_location(
        "variant_build", pkg / "_build.py")
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    want_flags = dict(_build.SOURCE_FLAGS)
    del want_flags["mh_sweep_k3g.cu"]
    assert build.SOURCE_FLAGS == want_flags
    for src in sorted((ROOT_PKG / "csrc").iterdir()):
        if src.name not in ("mh_sweep_k2g.cu", "mh_sweep_k3g.cu",
                            variant.GENERIC_SOURCE):
            assert (pkg / "csrc" / src.name).read_text() == src.read_text()
    assert variant.k4_source_lanes(pkg) == variant.k4_source_lanes()
    assert variant.k3_source_lanes(pkg) == variant.k3_source_lanes()
    with pytest.raises(SystemExit):
        variant.main([str(tmp_path), "--k2g", "8192=32"])
    with pytest.raises(SystemExit):
        variant.main([str(tmp_path), "--set", "kMinBlocks=3"])


def test_lane_variant_sets_the_kernels_and_the_plain_versions_lanes(
        tmp_path):
    import importlib.util

    pkg = variant.write_variant(tmp_path, mh_8x8=8,
                                k4={"8x8": 8, "16x16": 32, "bridge16x16": 16})
    root = Path(variant.__file__).resolve().parents[1] / "smcdet_tpu_torch"

    def constants(path):
        return variant._constants(path.read_text())

    want = constants(root / "csrc" / "mh_sweep_k2.cu")
    assert want["kLanes8x8"] == 4
    assert constants(pkg / "csrc" / "mh_sweep_k2.cu") == dict(want,
                                                               kLanes8x8=8)
    got = variant.k4_source_lanes(pkg)
    want = variant.k4_source_lanes()
    want.update({((8, 8), False): 8, ((16, 16), False): 32,
                 ((16, 16), True): 16})
    assert got == want
    spec = importlib.util.spec_from_file_location(
        "variant_mala_sweep", pkg / "ops" / "mala_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.K4_LANES == got
    for other in ("mh_sweep_k3.cu", "mh_pixel.cuh"):
        assert (pkg / "csrc" / other).read_text() == (
            root / "csrc" / other).read_text()
    with pytest.raises(SystemExit):
        variant.main([str(tmp_path), "--k4", "9x9=4"])


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in for nvcc that records its arguments and writes its -o
    file; the build directory in ``tmp_path``."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    calls = tmp_path / "calls.txt"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        f"open({str(calls)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return calls


def _compiles(calls):
    return [line.split() for line in calls.read_text().splitlines()
            if " -c " in f" {line} "]


def test_build_of_a_variant_compiles_every_source_with_its_flags(fake_nvcc):
    flags = {"mh_sweep_k2.cu": ["-DVARIANT=1"]}
    info = _build.build(source_flags=flags)
    variant = _compiles(fake_nvcc)
    names = sorted(Path(c[-1]).name for c in variant)
    assert names == sorted(src.name for src in _build._sources())
    assert [Path(c[-1]).name for c in variant if "-DVARIANT=1" in c] == [
        "mh_sweep_k2.cu"]
    assert not any("-fmad=false" in c for c in variant)
    assert info["path"].is_file() and info["seconds"] > 0.0
    assert info["path"].parent == _build.BUILD_DIR

    full = _build.build()
    default = _compiles(fake_nvcc)[len(variant):]
    assert full["path"] != info["path"]
    assert sorted(Path(c[-1]).name for c in default
                  if "-fmad=false" in c) == [
        "mala_sweep_k4.cu", "mala_sweep_k4g.cu", "mala_sweep_k4g_bridge.cu",
        "mala_sweep_wide.cu", "mh_sweep_k2g.cu", "mh_sweep_k3g.cu",
        "mh_sweep_wide.cu"]

    again = _build.build(source_flags=flags)
    assert again["path"] == info["path"] and again["seconds"] == 0.0
    assert len(_compiles(fake_nvcc)) == 2 * len(names)


def test_build_names_a_library_by_its_flags():
    k2 = {"mh_sweep_k2.cu": ["-DX=1"]}
    assert _build._digest(k2) == _build._digest(dict(k2))
    assert _build._digest(k2) != _build._digest({})
    assert _build._digest(k2) != _build._digest({"mh_sweep_k2.cu": ["-DX=2"]})
    assert _build._digest({}) != _build._digest(_build.SOURCE_FLAGS)


@pytest.fixture(scope="module")
def basic_launch():
    """The flattened arguments of a small launch of the basic suite's
    target on the CPU: 1 tile x 9 strata x 8 particles, 3 sweeps."""
    prior, model, kernel, _ = chip_smoke.suite_problem("cpu", "basic")
    problem = chip_smoke._kernel_inputs("cpu", prior, model, 1, 8, 0)
    key = torch.tensor([12345, 67890], dtype=torch.int64)
    return chip_smoke._sweep_args(key, kernel, *problem, 3)


def test_launch_agreement_of_a_version_with_itself(basic_launch):
    from smcdet_tpu_torch.ops import mh_sweep

    share, err = chip_smoke.launch_agreement(
        mh_sweep.mh_sweeps, mh_sweep.mh_sweeps_reference, basic_launch,
        sweeps=3)
    assert share == 1.0 and err == 0.0


@pytest.mark.parametrize("fault, message", [
    ("moves an empty particle", "passthrough"),
    ("disagrees on every occupied particle", r"^0\.\d+$")])
def test_launch_agreement_catches_a_faulty_kernel(basic_launch, fault,
                                                  message):
    from smcdet_tpu_torch.ops import mh_sweep

    def faulty(*args, child=None):
        outs = list(mh_sweep.mh_sweeps(*args, child=child))
        if fault == "moves an empty particle":
            outs[3] = outs[3].clone()
            outs[3][0, 0] += 1.0
        else:
            outs[3] = torch.where(args[6] > 0, outs[3] + 1.0, outs[3])
        return tuple(outs)

    with pytest.raises(AssertionError, match=message):
        chip_smoke.launch_agreement(faulty, mh_sweep.mh_sweeps_reference,
                                    basic_launch, sweeps=3)


def test_print_paths_ranks_kernels_by_launches_times_gap(capsys):
    def rec(ms, bound):
        return {"ms": ms, "bound_ms": bound, "measured_bound_ms": bound,
                "shape": "s"}

    chip_smoke.print_paths([("K1", "a", 10, rec(3.0, 1.0)),
                            ("K2", "b", 5, rec(10.0, 2.0)),
                            ("K1", "c", 100, rec(0.5, 0.25))])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4
    assert "launches x (time - bound) 0.040 s" in out[1]
    assert out[-1] == ("[paths] kernels by launches x (time - bound): "
                       "K1 0.045 s, K2 0.040 s")


def test_print_paths_leaves_a_missed_trace_unranked(capsys):
    """A record whose trace missed the kernel (``ms`` None) is printed as
    unranked and adds nothing to its kernel's sum: the host's wall a launch
    is never ranked as the kernel's time."""
    chip_smoke.print_paths([
        ("K4", "blocks", 10000, {"ms": None, "bound_ms": 1e-5,
                                 "measured_bound_ms": 1e-5, "shape": "s"}),
        ("K4", "tiles", 10, {"ms": 3.0, "bound_ms": 1.0,
                             "measured_bound_ms": 1.0, "shape": "s"})])
    out = capsys.readouterr().out.splitlines()
    assert "unranked (the trace missed the kernel)" in out[0]
    assert out[-1] == ("[paths] kernels by launches x (time - bound): "
                       "K4 0.020 s")


def test_binomial_floor_is_the_lower_tail_at_the_reference_rate():
    # every one of 40 image-runs within +-1, and 32 of 40
    assert chip_smoke.binomial_floor(40, 40) == 37
    assert chip_smoke.binomial_floor(40, 32) == 27
    assert chip_smoke.binomial_floor(40, 32, alpha=1.0) == 40
    assert chip_smoke.binomial_floor(40, 0, alpha=1e-12) == 0
    # a reference of another size: its rule-of-succession rate (11 / 12,
    # 8 / 10), held over 100 trials
    assert chip_smoke.binomial_floor(100, 10, n_ref=10) == 87
    assert chip_smoke.binomial_floor(100, 7, n_ref=8) == 73
    assert chip_smoke.binomial_floor(40, 32, n_ref=40) == 27


def _fake_dnc_runs(within, converged):
    """``chip_smoke.dnc_runs``' result for runs that put ``within[r]`` of
    the 4 images within +-1 of the truth, each image at one bridge level of
    3 iterations."""
    truth = np.array(chip_smoke.DNC_TRUE_COUNTS)
    levels = [[(3, [1.0], 0.5)] for _ in truth]
    launches = {"K1": 10, "K2": 0, "K3": 12, "K4 tile": 0, "K4 bridge": 0,
                "K5": 0}
    return truth, [(launches, levels, [converged] * 4,
                    truth + np.where(np.arange(4) < w, 0.2, 2.5))
                   for w in within]


@pytest.mark.parametrize("kind", ["MH", "MALA"])
@pytest.mark.parametrize("within, converged, ok_mh, ok_mala", [
    ([3] + [4] * 9, True, True, True),  # the config seed's run misses one
    ([4, 4, 4, 3, 3, 3, 4, 4, 4, 4], True, True, True),     # 37 of 40
    ([4, 4, 3, 3, 3, 3, 3, 4, 4, 4], True, False, True),    # 35 of 40
    ([4, 3, 3, 3, 3, 3, 3, 3, 3, 1], True, False, False),   # 29 of 40
    ([4] * 10, False, False, False)])
def test_dnc_batch_holds_the_runs_to_the_earlier_kernels_rate(
        monkeypatch, capsys, within, converged, ok_mh, ok_mala, kind):
    """The 40 image-runs within +-1 are held to ``binomial_floor`` at the
    JAX runner's count on the same seeds, ``DNC_JAX_WITHIN`` (MH 39, floor
    36; MALA 35, floor 30); the config seed's single run is printed, not
    held."""
    from types import SimpleNamespace

    reference = chip_smoke.DNC_JAX_WITHIN[kind]
    assert reference == sum(chip_smoke.DNC_JAX_WITHIN_BY_SEED[kind])
    assert len(chip_smoke.DNC_JAX_WITHIN_BY_SEED[kind]) == \
        chip_smoke.DNC_RUNS
    floor = chip_smoke.binomial_floor(40, reference)
    assert floor == {"MH": 36, "MALA": 30}[kind]
    monkeypatch.setattr(chip_smoke, "DNC_RUNS", len(within))
    monkeypatch.setattr(chip_smoke, "dnc_runs",
                        lambda *a: _fake_dnc_runs(within, converged))
    hits = sum(within)
    ok = ok_mh if kind == "MH" else ok_mala
    assert ok == (converged and hits >= floor)

    def run():
        return chip_smoke._dnc_batch(None, SimpleNamespace(seed=5), "dnc",
                                     1.0, 1.0, reference)

    if not ok:
        with pytest.raises(AssertionError):
            run()
        return
    assert run()["bridge levels"] == [12]
    out = capsys.readouterr().out
    first = "meets" if within[0] == 4 else "misses"
    assert f"the config seed's run: {within[0]}/4 within +-1 ({first}" in out
    assert f"{hits}/40 image-runs within +-1" in out
