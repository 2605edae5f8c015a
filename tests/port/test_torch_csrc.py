"""What the CPU can check of the CUDA sources, which only the card
compiles: the field and curve constants in csrc/*.cuh equal the port's
FieldSpec values, and every C entry point bound in build.py exists with
the argument count given to ctypes."""

import os
import re

import pytest

from kzg_tpu_torch import build
from kzg_tpu_torch.curve.glv import GLV_BETA
from kzg_tpu_torch.field import fp, fr


def source(name: str) -> str:
    with open(os.path.join(build.CSRC, name)) as f:
        return f.read()


def words_after(text: str, anchor: str, count: int) -> int:
    """The `count` hex words of the first array after `anchor`, as one
    little-endian integer."""
    tail = text[text.index(anchor):]
    words = re.findall(r"0x([0-9a-fA-F]{8})u", tail)[:count]
    assert len(words) == count
    return sum(int(w, 16) << (32 * i) for i, w in enumerate(words))


@pytest.mark.parametrize("spec", [fr.SPEC, fp.SPEC], ids=["Fr", "Fp"])
def test_field_header_constants(spec):
    text = source("field.cuh")
    block = text[text.index(f"struct Field<{spec.n_words}>"):]
    n0 = int(re.search(r"n0 = 0x([0-9a-f]{8})u", block).group(1), 16)
    assert n0 == spec.n0
    assert words_after(block, "M[", spec.n_words) == spec.modulus


def test_curve_header_constants():
    text = source("g1.cuh")
    assert words_after(text, "void fp_one", 12) == fp.SPEC.one_mont
    assert words_after(text, "void fp_beta", 12) == \
        fp.SPEC.to_mont_int(GLV_BETA)


@pytest.mark.parametrize("fn,argc", [("kzg_mont_mul", 7),
                                     ("kzg_butterfly", 9)])
def test_field_generic_entry_points(fn, argc):
    """The entry points that take any FieldSpec launch their template for
    N = 8 (Fr) and N = 12 (Fp) and refuse other widths."""
    assert len(build.SIGNATURES["fr_kernels"][fn]) == argc
    text = source("fr_kernels.cu")
    body = text[text.index(f'extern "C" int {fn}('):]
    body = body[:body.index("\n}\n")]
    kernel = {"kzg_mont_mul": "mont_mul_kernel",
              "kzg_butterfly": "butterfly_stream_kernel"}[fn]
    for n in (fp.SPEC.n_words, fr.SPEC.n_words):
        assert f"n_words == {n}" in body
        assert f"{kernel}<{n}><<<" in body
    assert "cudaErrorInvalidValue" in body


def test_signed_windows_entry_point():
    """fr_signed_windows takes Montgomery words, reduces them in the
    kernel (field.cuh's from_mont) and launches one kernel; the streaming
    butterfly sizes its grid to the SMs."""
    fn = "kzg_fr_signed_windows"
    assert len(build.SIGNATURES["fr_kernels"][fn]) == 4
    text = source("fr_kernels.cu")
    params = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)",
                       text).group(1).split(",")
    assert [p.split()[-1] for p in params] == ["out", "a", "n", "stream"]
    body = text[text.index(f'extern "C" int {fn}('):]
    body = body[:body.index("\n}\n")]
    assert "signed_windows_kernel<<<" in body
    assert "kzg::from_mont<8>(t);" in text
    assert "void from_mont(uint32_t t[N])" in source("field.cuh")
    assert "butterfly_stream_kernel(int32_t* __restrict__ hi" in text
    assert "stream_grid(butterfly_stream_kernel<8>, n)" in text


def test_entry_points_match_bindings():
    for lib, fns in build.SIGNATURES.items():
        assert lib in build.SOURCES
        text = source(f"{lib}.cu")
        for fn, argtypes in fns.items():
            m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
            assert m, fn
            assert len(m.group(1).split(",")) == len(argtypes), fn


def test_entry_point_argument_types():
    """Each C parameter is a pointer (void*) or an int, in the order of
    the ctypes argtypes: a pointer bound as an int would be cut to 32
    bits."""
    kinds = {"void*": build._P, "int": build._I}
    for lib, fns in build.SIGNATURES.items():
        text = source(f"{lib}.cu")
        for fn, argtypes in fns.items():
            params = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)",
                               text).group(1).split(",")
            got = [kinds["void*" if "*" in p else p.split()[-2]]
                   for p in params]
            assert got == list(argtypes), fn


def test_ladder_layout_constants():
    """The stage kernel's block size, its staged table stride and the
    fixed-base kernel's threads per lane and windows equal the wrapper's
    (curve/kernels.py), which sizes the shared memory and the grids."""
    from kzg_tpu_torch.curve import kernels as gk

    stage = source("g1_fft_kernels.cu")
    assert f"constexpr int kThreads = {gk.STAGE_THREADS};" in stage
    assert "kTabStride = kzg::TW + 4;" in stage
    assert gk.TABLE_SMEM_WORDS == 8 * gk.PW + 4
    g1h = source("g1.cuh")
    assert "constexpr int PW = 3 * NP;" in g1h
    assert "constexpr int TW = 8 * PW;" in g1h
    table = source("g1_table_kernels.cu")
    assert f"constexpr int kParts = {gk.FIXED_PARTS};" in table
    assert f"constexpr int kWindows = {gk.FIXED_WINDOWS};" in table


@pytest.mark.parametrize("lib,fn,argc", [
    ("g1_sum_kernels", "kzg_g1_sum", 11),
    ("g1_sum_kernels", "kzg_g1_horner", 8),
    ("g1_table_kernels", "kzg_g1_fixed_base_mul", 8)])
def test_row_sum_entry_points(lib, fn, argc):
    """g1_sum (rows, n, inner, blocks a row), g1_horner (MSMs) and the
    fixed-base product with its base count are bound with their C
    argument counts, and build.py compiles their source."""
    assert lib in build.SOURCES
    assert len(build.SIGNATURES[lib][fn]) == argc
    params = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)",
                       source(f"{lib}.cu")).group(1).split(",")
    assert len(params) == argc


def test_sum_layout_constants():
    """g1_sum's block size and run length, which the plain version's
    partition follows, and g1_horner's window count equal the wrapper's."""
    from kzg_tpu_torch.curve import kernels as gk

    text = source("g1_sum_kernels.cu")
    assert f"constexpr int kThreads = {gk.SUM_THREADS};" in text
    assert f"constexpr int kRun = {gk.SUM_RUN};" in text
    assert f"constexpr int kWindows = {gk.FIXED_WINDOWS};" in text


@pytest.mark.parametrize("spec", [fr.SPEC, fp.SPEC], ids=["Fr", "Fp"])
def test_field_header_one(spec):
    """Field<N>::one, which the route kernels start their products from,
    is R mod m."""
    text = source("field.cuh")
    block = text[text.index(f"struct Field<{spec.n_words}>"):]
    assert words_after(block, "one(int i)", spec.n_words) == spec.one_mont


def test_route_layout_constants():
    """The route kernels' op codes, block sizes, tile limit and leaf shape
    equal the wrappers' (field/kernels.py), which plan the launches and
    whose plain versions follow the same layout."""
    from kzg_tpu_torch.field import kernels as fk

    text = source("fr_route_kernels.cu")
    assert "enum { kAdd = 0, kSub = 1, kNeg = 2 };" in text
    assert fk.ADD_SUB_OPS == {"add": 0, "sub": 1, "neg": 2}
    assert "enum { kInvFull = 0, kInvUp = 1, kInvDown = 2 };" in text
    assert (fk._INV_FULL, fk._INV_UP, fk._INV_DOWN) == (0, 1, 2)
    for name, value in (("kInvThreads", fk.INV_THREADS),
                        ("kInvBlockLanes", fk.INV_BLOCK_LANES),
                        ("kFftTileLog", fk.FFT_TILE_LOG),
                        ("kLeafWidth", fk.LEAF_WIDTH),
                        ("kLeafFactors", fk.LEAF_FACTORS)):
        assert f"constexpr int {name} = {value};" in text
    assert fk.INV_BLOCK_LANES % fk.INV_THREADS == 0
    # the widest tile and its padding fit a block's 227 KB
    assert 8 * ((1 << fk.FFT_TILE_LOG) + 4) * 4 <= 232448


def test_das_block_entry_point():
    """fr_das_block's C entry point is bound with its argument count, its
    sweep codes equal the wrapper's, which plans the passes, and it takes
    fr_fft_block's tiles: the same widest tile, threads and launch
    set-up."""
    from kzg_tpu_torch.field import kernels as fk

    fn = "kzg_fr_das_block"
    text = source("fr_route_kernels.cu")
    params = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)",
                       text).group(1).split(",")
    assert len(params) == len(build.SIGNATURES["fr_route_kernels"][fn]) == 13
    assert "enum { kDasDown = 1, kDasUp = 2 };" in text
    assert (fk.DAS_DOWN, fk.DAS_UP) == (1, 2)
    body = text[text.index('extern "C" int ' + fn):]
    body = body[:body.index("\n}\n")]
    assert "kk > kFftTileLog" in body and "tile_pass(" in body
    assert "__launch_bounds__(kFftThreads)\n    das_block_kernel" in text
    assert fk.das_plan(20) == ((10, 10, fk.DAS_DOWN),
                               (0, 10, fk.DAS_DOWN | fk.DAS_UP),
                               (10, 10, fk.DAS_UP))
    assert max(kk for _, kk, _ in fk.das_plan(22)) == fk.FFT_TILE_LOG


@pytest.mark.parametrize("fn,kernel,argc", [
    ("kzg_fr_add_sub", "add_sub_kernel", 8),
    ("kzg_fr_pow", "pow_kernel", 7)])
def test_route_generic_entry_points(fn, kernel, argc):
    """add/sub/neg and the ladder launch their template for N = 8 (Fr)
    and N = 12 (Fp) and refuse other widths."""
    assert "fr_route_kernels" in build.SOURCES
    assert len(build.SIGNATURES["fr_route_kernels"][fn]) == argc
    text = source("fr_route_kernels.cu")
    body = text[text.index(f'extern "C" int {fn}('):]
    body = body[:body.index("\n}\n")]
    for n in (fp.SPEC.n_words, fr.SPEC.n_words):
        assert f"n_words == {n}" in body
        assert f"{kernel}<{n}><<<" in body
    assert "cudaErrorInvalidValue" in body
