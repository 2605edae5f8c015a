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


@pytest.mark.parametrize("fn,argc", [("kzg_g2_scalar_mul", 10),
                                     ("kzg_pairing_lines", 5),
                                     ("kzg_pairing_miller_eval", 14),
                                     ("kzg_pairing_final_exp", 6)])
def test_pairing_entry_points(fn, argc):
    """The pairing kernels' C entry points are bound with their argument
    counts, build.py compiles their source, and each launches its kernel
    and returns cudaGetLastError."""
    assert "pairing_kernels" in build.SOURCES
    assert len(build.SIGNATURES["pairing_kernels"][fn]) == argc
    text = source("pairing_kernels.cu")
    body = text[text.index(f'extern "C" int {fn}('):]
    body = body[:body.index("\n}\n")]
    kernel = fn[len("kzg_"):] + "_kernel<<<"
    assert kernel in body and "cudaGetLastError()" in body


def test_pairing_constants():
    """The Miller loop's bits are |x| (x < 0, so the kernel and its plain
    version conjugate), a point has as many lines as the loop has steps,
    the inverse's last factor is R^3 (a^-1 R^3 / R = x^-1 R for a = x R),
    the hard part's bits are |x| and |c|, and the kernels' block and table
    sizes fit a block's shared memory."""
    from kzg_tpu_torch.curve import pairing_kernels as pk
    from kzg_tpu_torch.field.constants import BLS_X

    tower = source("tower.cuh")
    m = re.search(r"kMillerBits = 0x([0-9a-f]+)ull;", tower)
    assert int(m.group(1), 16) == -BLS_X and BLS_X < 0
    assert f"kMillerTop = {(-BLS_X).bit_length() - 1};" in tower
    assert pk.MILLER_BITS == format(-BLS_X, "b")[1:]
    assert f"kLines = {pk.N_LINES};" in tower
    assert pk.N_LINES == 63 + 5
    assert "conj_g(f, f, g);" in tower
    m = re.search(r"kHardCBits = 0x([0-9a-f]+)ull;", tower)
    assert int(m.group(1), 16) == pk.HARD_C
    assert f"kHardCTop = {pk.HARD_C.bit_length() - 1};" in tower
    assert not re.search(r"Fp12 \w+\[16\]", tower)     # no table
    assert words_after(tower, "constexpr uint32_t kR3[NF]", 12) == \
        pow(2, 3 * 384, fp.SPEC.modulus)
    kernels = source("pairing_kernels.cu")
    assert "constexpr int kSmem = kThreads * kzg::T2W * 4;" in kernels
    assert "constexpr int T2W = 8 * P2W;" in tower
    assert "constexpr int P2W = 6 * NF;" in tower
    threads = int(re.search(r"constexpr int kThreads = (\d+);",
                            kernels).group(1))
    assert threads * 8 * 6 * 12 * 4 <= 232448
    # a warp's scratch: 18 operand pairs (48 words), 54 Fp products, 9
    # Fp2 tier values; a block of kBlock / kGroup lanes, a warp each
    assert "constexpr int kGrpWords = 18 * 48 + 54 * NF + 9 * 2 * NF;" \
        in tower
    assert "constexpr int kGroup = 32;" in tower
    assert "constexpr int kLanesABlock = kBlock / kzg::kGroup;" in kernels
    block = int(re.search(r"constexpr int kBlock = (\d+);",
                          kernels).group(1))
    grp_words = 18 * 48 + 54 * 12 + 9 * 24
    lane_words = max(2 * 144 + 6 * 12, 4 * 144)
    assert block % 32 == 0
    assert block // 32 * (lane_words + grp_words) * 4 <= 232448


def test_hard_part_decomposition():
    """K-c's x-chain computes the reference's hard exponent exactly:
    (p^4 - p^2 + 1)/r = c (x - 1)(x + p)(x^2 + p^2 - 1) + 1 with
    c = (x - 1)/3, checked in host ints against the bits the kernel holds
    (kMillerBits = |x|, kHardCBits = |c|), not its cube (the 3d of
    Hayashida-Hayasaka-Teruya)."""
    from kzg_tpu_torch.field.constants import FR_MODULUS

    tower = source("tower.cuh")
    x = -int(re.search(r"kMillerBits = 0x([0-9a-f]+)ull;", tower).group(1),
             16)
    c = -int(re.search(r"kHardCBits = 0x([0-9a-f]+)ull;", tower).group(1),
             16)
    p, r = fp.SPEC.modulus, FR_MODULUS
    assert (x - 1) % 3 == 0 and c == (x - 1) // 3
    d = (p ** 4 - p ** 2 + 1) // r
    assert (p ** 4 - p ** 2 + 1) % r == 0
    assert d == c * (x - 1) * (x + p) * (x * x + p * p - 1) + 1
    assert d % 3 != 0


def test_frobenius_gammas_host_derivation():
    """The gammas passed to K-c, xi^(e (p - 1)/6) for slot e = j + 2i,
    equal the coefficient of basis^p in the exact tower
    (curve/pairing.py), as kzg_tpu derives them; each of p^2 and p^3 is
    p's map applied again."""
    from kzg_tpu_torch.curve import pairing as hp
    from kzg_tpu_torch.curve import pairing_kernels as pk

    p = fp.SPEC.modulus
    z = hp.F2.ZERO
    for j in range(2):
        for i in range(3):
            slots = [[z] * 3, [z] * 3]
            slots[j][i] = hp.F2.ONE
            b = hp.F12(hp.F6(*slots[0]), hp.F6(*slots[1]))
            bp = b.pow(p)
            g = (bp.c0, bp.c1)[j]
            g = (g.c0, g.c1, g.c2)[i]
            assert (g.a, g.b) == pk.frobenius_gamma_ints(1)[3 * j + i]
            for k in (2, 3):      # gamma_k = gamma_{k-1}^p gamma_1
                prev = hp.F2(*pk.frobenius_gamma_ints(k - 1)[3 * j + i])
                frob = prev.conj() * hp.F2(*pk.frobenius_gamma_ints(1)
                                           [3 * j + i])
                assert (frob.a, frob.b) == \
                    pk.frobenius_gamma_ints(k)[3 * j + i]


@pytest.mark.parametrize("spec", [fr.SPEC, fp.SPEC], ids=["Fr", "Fp"])
def test_exp_field_nprime_words(spec):
    """The full-width n' = -m^-1 mod R written into exp_field_kernels.cu
    (the CUDA-core pass and X12's constant operand) equals its host
    derivation, FieldSpec.nprime."""
    text = source("exp_field_kernels.cu")
    block = text[text.index(f"struct NPrime<{spec.n_words}>"):]
    assert words_after(block, "W[", spec.n_words) == spec.nprime
    assert spec.nprime == (-pow(spec.modulus, -1, spec.r)) % spec.r


@pytest.mark.parametrize("fn,argc,first", [
    ("kzg_exp_mont_chain", 10, "n_words"),
    ("kzg_exp_tc_mont_mul", 8, "mode"),
    ("kzg_exp_op_chain", 6, "op")])
def test_exp_field_entry_points(fn, argc, first):
    """The experiments' entry points are bound with their C argument
    counts, and their case numbers follow the wrapper's tuples
    (experiments/kernels.py: VARIANTS, MODES, OPS)."""
    from kzg_tpu_torch.experiments import kernels as ek

    text = source("exp_field_kernels.cu")
    assert "exp_field_kernels" in build.SOURCES
    assert len(build.SIGNATURES["exp_field_kernels"][fn]) == argc
    params = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)",
                       text).group(1).split(",")
    assert params[0].split()[-1] == first
    assert "// variant 0, 1, 2 = A, B, C;" in text
    assert ek.VARIANTS == ("A", "B", "C")
    assert "// mode 0: REDC(a*b); 1: a * n' mod R on the tensor cores; 2:" \
        in text and ek.MODES == ("hybrid", "tc_pass", "cc_pass")
    assert ("enum Op { kMulC = 0, kAdd, kSubFromM, kCarryChain, kGeqWhere, "
            "kCondSub };") in text
    assert ek.OPS == ("mont_mul(x,c)", "mod_add(x,x)", "mod_sub(m,x)",
                      "carry_fold", "geq+where", "cond_sub")


def test_exp_field_tensor_core_passes():
    """X1-C and X2 issue mma.sync u8 x u8 -> s32 (no library call)."""
    text = source("exp_field_kernels.cu")
    assert "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32" in text


@pytest.mark.parametrize("fn,argc,first", [
    ("kzg_exp_tuple_chain", 7, "body"),
    ("kzg_exp_ext_chain", 11, "op"),
    ("kzg_exp_ext_body", 11, "body")])
def test_exp_chain_entry_points(fn, argc, first):
    """The product bodies' entry points are bound with their C argument
    counts, and their case numbers follow the wrapper's (BODIES,
    PRODUCT_CODES, TUPLE_CASES and TUPLE_CASES_X789; EXT_OPS, EXT_CASES,
    EXT_CHECK_CASES; EXT_BODIES): the C switch holds exactly the
    wrapper's cases."""
    from kzg_tpu_torch.experiments import kernels as ek

    text = source("exp_field_kernels.cu")
    assert len(build.SIGNATURES["exp_field_kernels"][fn]) == argc
    params = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)",
                       text).group(1).split(",")
    assert params[0].split()[-1] == first
    body = text[text.index(f'extern "C" int {fn}('):]
    body = body[:body.index("\n}\n")]
    assert ("enum Product { kMont12 = 0, kLazy12, kLazy13, kLazy16, "
            "kSqr12 };") in text
    assert ("enum Body { kTuple3 = 0, kSingle, kSerial, kSerial8, kSerial1, "
            "kTransp };") in text
    assert ("enum ExtBody { kSevenConv = 0, kSevenCtx, kIndep8, kDblShape "
            "};") in text
    assert "enum ExtOp { kLazyAdd = 0, kLazySub, kRawAdd };" in \
        source("lazy.cuh")
    assert ek.PRODUCTS == ("mont12", "lazy12", "lazy13", "lazy16")
    assert ek.PRODUCT_CODES == ek.PRODUCTS + ("sqr12",)
    assert ek.BODIES == ("tuple3", "single", "serial", "serial8", "serial1",
                         "transp")
    assert ek.EXT_OPS == {"adds": 0, "subs": 1, "fold": 0, "raw": 2}
    assert ek.EXT_BODIES == ("conv", "ctx", "indep8", "dblshape")
    if fn == "kzg_exp_tuple_chain":
        cases = re.findall(r"launch_tuple<k(\w+), k(\w+)>", body)
        assert sorted((b.lower(), p.lower()) for b, p in cases) == \
            sorted(ek.TUPLE_CASES + ek.TUPLE_CASES_X789)
    elif fn == "kzg_exp_ext_body":
        names = {"SevenConv": "conv", "SevenCtx": "ctx", "Indep8": "indep8",
                 "DblShape": "dblshape"}
        cases = re.findall(r"launch_ext_body<k(\w+)>", body)
        assert [names[c] for c in cases] == list(ek.EXT_BODIES)
    else:
        names = {"LazyAdd": 0, "LazySub": 1, "RawAdd": 2}
        cases = re.findall(r"launch_ext<k(\w+), (\d+)>", body)
        assert sorted((names[o], int(n)) for o, n in cases) == sorted(
            {(ek.EXT_OPS[k], n)
             for k, n in ek.EXT_CASES + ek.EXT_CHECK_CASES})


def test_exp_chain_constants():
    """The 13-word lazy domain's constants in lazy.cuh (C_IN, C_OUT, K m,
    one_ext), which exp_field_kernels.cu and exp_point_kernels.cu include,
    equal the wrapper's, and the lazy products' padded moduli take Fp's
    words and n0."""
    from kzg_tpu_torch.experiments import kernels as ek
    from kzg_tpu_torch.experiments import point_kernels as ptk

    lazy = source("lazy.cuh")
    ext = lazy[lazy.index("struct Ext {"):]
    for anchor, want in (("c_in(int i)", ek.EXT_C_IN),
                         ("c_out(int i)", ek.EXT_C_OUT),
                         ("km(int i)", ek.EXT_KM),
                         ("one(int i)", ptk.EXT_ONE)):
        assert words_after(ext, anchor, ek.EXT_WORDS) == want
    assert ek.EXT_C_IN == pow(2, 2 * 416 - 384, fp.SPEC.modulus)
    assert ek.EXT_C_OUT == pow(2, 384, fp.SPEC.modulus)
    assert ek.EXT_KM == 64 * fp.SPEC.modulus < 1 << 416
    assert ptk.EXT_ONE == pow(2, 416, fp.SPEC.modulus)
    for name in ("exp_field_kernels.cu", "exp_point_kernels.cu"):
        assert '#include "lazy.cuh"' in source(name)
        assert "struct Ext {" not in source(name)
    for n, text in ((14, lazy), (16, source("exp_field_kernels.cu"))):
        block = text[text.index(f"struct Field<{n}> {{"):]
        block = block[:block.index("};")]
        assert "n0 = Field<12>::n0;" in block
        assert "return i < 12 ? Field<12>::m(i) : 0u;" in block


def test_exp_point_entry_point():
    """exp_point_chain's entry point is bound with its C argument count
    in a library of its own, its domain and op numbers follow the
    wrapper's (DOMAINS, OPS), and its switch holds exactly POINT_CASES."""
    from kzg_tpu_torch.experiments import point_kernels as ptk

    text = source("exp_point_kernels.cu")
    fn = "kzg_exp_point_chain"
    assert "exp_point_kernels" in build.SOURCES
    assert len(build.SIGNATURES["exp_point_kernels"][fn]) == 12
    params = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)",
                       text).group(1).split(",")
    assert [p.split()[-1] for p in params[:3]] == ["domain", "op",
                                                   "threads"]
    assert "enum Domain { kJac = 0, kLazy, kLadder };" in text
    assert "enum Op { kDouble = 0, kAdd, kWstep };" in text
    assert ptk.DOMAINS == ("jac", "lazy", "ladder")
    assert ptk.OPS == ("double", "add", "wstep")
    body = text[text.index(f'extern "C" int {fn}('):]
    cases = re.findall(r"return launch<k(\w+), k(\w+), (\d+)>", body)
    assert sorted((d.lower(), o.lower(), int(t)) for d, o, t in cases) == \
        sorted(ptk.POINT_CASES)


def test_jacobian_formulas_shared():
    """g1_point_kernels.cu and exp_point_kernels.cu take the Jacobian
    formulas from one header, g1_jac.cuh; neither keeps a copy."""
    jac = source("g1_jac.cuh")
    for name in ("struct Jac {", "void jac_double(", "void jac_add("):
        assert name in jac
        for user in ("g1_point_kernels.cu", "exp_point_kernels.cu"):
            assert name not in source(user)
    for user in ("g1_point_kernels.cu", "exp_point_kernels.cu"):
        assert '#include "g1_jac.cuh"' in source(user)
