"""BLS12-381 field and curve constants (the port's own copy of
kzg_tpu/field/constants.py, which it may not import).

Roots of unity are derived as pow(7, (r-1) >> k, r) rather than copied
from a table (reference: bls/globals.go:27-60).
"""

# Scalar field modulus r (order of the G1/G2 subgroups).
FR_MODULUS = int(
    "52435875175126190479447740508185965837690552500527637822603658699938581184513"
)
# = 0x73eda753299d7d483339d80809a1d80553bda402fffe5bfeffffffff00000001

# Base field modulus p.
FP_MODULUS = int(
    "0x1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab",
    16,
)

# Multiplicative generator of Fr* used to derive roots of unity
# (reference: bls/globals.go:23 "PRIMITIVE_ROOT = 7").
FR_PRIMITIVE_ROOT = 7

# The 2-adicity of r-1: r-1 = 2^32 * odd.
FR_TWO_ADICITY = 32

# The BLS parameter x (negative): the Miller loop runs over |x|.
BLS_X = -0xD201000000010000

# Curve equations: E/Fp:  y^2 = x^3 + 4
#                  E'/Fp2: y^2 = x^3 + 4*(u+1)
CURVE_B = 4

# G1 generator, affine, canonical integer coordinates.
G1_GENERATOR_X = int(
    "0x17f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
    "6c55e83ff97a1aeffb3af00adb22c6bb",
    16,
)
G1_GENERATOR_Y = int(
    "0x08b3f481e3aaa0f1a09e30ed741d8ae4fcf5e095d5d00af600db18cb2c04b3ed"
    "d03cc744a2888ae40caa232946c5e7e1",
    16,
)

# G2 generator (affine, coordinates in Fp2 as (c0, c1) with u^2 = -1).
G2_GENERATOR_X = (
    int("0x024aa2b2f08f0a91260805272dc51051c6e47ad4fa403b02b4510b647ae3d177"
        "0bac0326a805bbefd48056c8c121bdb8", 16),
    int("0x13e02b6052719f607dacd3a088274f65596bd0d09920b61ab5da61bbdc7f5049"
        "334cf11213945d57e5ac7d055d042b7e", 16),
)
G2_GENERATOR_Y = (
    int("0x0ce5d527727d6e118cc9cdc6da2e351aadfd9baa8cbdd3a76d429a695160d12c"
        "923ac9cc3baca289e193548608b82801", 16),
    int("0x0606c4a02ea734cc32acd2b02bc28b99cb3e287e85a763af267492ab572e99ab"
        "3f370d275cec1da1aaa9075ff05f79be", 16),
)


def fr_scale2_root_of_unity(scale: int) -> int:
    """2^scale-th root of unity in Fr (reference: bls/globals.go:27-60,
    derived there as pow(PRIMITIVE_ROOT, (MODULUS-1)//2**scale, MODULUS))."""
    if not 0 <= scale <= FR_TWO_ADICITY:
        raise ValueError(f"no 2^{scale} root of unity in Fr")
    return pow(FR_PRIMITIVE_ROOT, (FR_MODULUS - 1) >> scale, FR_MODULUS)


def is_power_of_two(v: int) -> bool:
    """reference: bls/globals.go:72 (true for 0, as there)."""
    return v & (v - 1) == 0
