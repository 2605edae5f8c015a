"""fft_g1(..., in_subgroup=False), the radix-2 route for any curve point
(K3 and g1_add; kzg_tpu/curve/fft_g1.py:76-101), against the JAX
package's recorded transforms of 8 and 16 points off the r-torsion, both
directions, compared exactly in affine form, and against the host's
radix-2 transform on the same twiddles. Off the r-torsion [a]P depends
on a mod ord(P), not on a mod r, so the transform there is not a DFT
over Fr: the oracle follows the same butterflies. On subgroup points the
route gives the direct DFT, and inverts."""

import pytest
from port_helpers import (
    CPU,
    FFT_G1_GENERIC_SCALE,
    bitrev,
    off_subgroup_case,
    port_to_ref,
    ref_to_port,
    reference,
    subgroup_affine,
)

from kzg_tpu_torch.curve import g1
from kzg_tpu_torch.curve.fft_g1 import fft_g1
from kzg_tpu_torch.curve.weierstrass import JacobianPoint
from kzg_tpu_torch.field import fr
from kzg_tpu_torch.ntt.domain import FFTSettings
from kzg_tpu_torch.utils import host_ec

R = fr.SPEC.modulus
FS = FFTSettings(FFT_G1_GENERIC_SCALE, CPU)


def host_radix2(aff, inverse: bool) -> list:
    """The reference's butterflies on host ints: the input bit-reversed,
    then per stage (a + [w]b, a - [w]b), an inverse times 1/n."""
    n = len(aff)
    roots = FS.roots_of_unity_int()
    if inverse:
        roots = roots[::-1]
    bits = n.bit_length() - 1
    x = [aff[bitrev(i, bits)] for i in range(n)]
    m = 1
    while m < n:
        m *= 2
        half, stride = m // 2, FS.max_width // m
        for g in range(0, n, m):
            for j in range(half):
                a = x[g + j]
                t = host_ec.g1_mul(x[g + j + half], roots[j * stride])
                x[g + j], x[g + j + half] = (host_ec.g1_add(a, t),
                                             host_ec.g1_sub(a, t))
    if inverse:
        x = [host_ec.g1_mul(p, pow(n, -1, R)) for p in x]
    return x


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("inverse", [False, True])
def test_generic_fft_off_subgroup(n, inverse):
    aff, pts = off_subgroup_case(n)
    got = g1.to_affine_ints_host(fft_g1(FS, pts, inverse, in_subgroup=False))
    want = reference(f"fft_g1_generic:{n}:{int(inverse)}",
                     *port_to_ref(pts))
    assert got == g1.to_affine_ints_host(ref_to_port(want))
    assert got == host_radix2(aff, inverse)


def test_glv_route_is_wrong_off_subgroup():
    """The GLV route's scalars assume phi(P) = lambda P, false off the
    r-torsion: why the generic route exists."""
    aff, pts = off_subgroup_case(8)
    assert g1.to_affine_ints_host(fft_g1(FS, pts)) != host_radix2(aff, False)


def test_generic_fft_subgroup_batch():
    """Two rows of 8 subgroup points: the generic route gives the DFT
    out[i] = sum_j [w^(ij)] P_j (as the GLV route does,
    test_torch_g1_fft_stages.py), and its inverse gives the points
    back."""
    aff = subgroup_affine(160, 16)
    pts = JacobianPoint(*(c.reshape(2, 8, 12) for c in
                          g1.from_affine_ints(aff, CPU)))
    fwd = fft_g1(FS, pts, in_subgroup=False)
    w = pow(FS.root_of_unity_int, FS.max_width // 8, R)
    for row in range(2):
        a = aff[8 * row:8 * row + 8]
        dft = []
        for i in range(8):
            acc = None
            for j, p in enumerate(a):
                acc = host_ec.g1_add(acc, host_ec.g1_mul(p, pow(w, i * j,
                                                                R)))
            dft.append(acc)
        assert g1.to_affine_ints_host(JacobianPoint(
            *(c[row] for c in fwd))) == dft
    back = fft_g1(FS, fwd, inverse=True, in_subgroup=False)
    assert g1.to_affine_ints_host(back) == aff


def test_generic_fft_edges():
    pts = g1.from_affine_ints(subgroup_affine(161, 3), CPU)
    with pytest.raises(ValueError, match="power-of-two"):
        fft_g1(FS, pts, in_subgroup=False)
    one = JacobianPoint(*(c[:1] for c in pts))
    assert fft_g1(FS, one, in_subgroup=False) is one
    big = g1.infinity((2 * FS.max_width,), CPU)
    with pytest.raises(ValueError, match="more values"):
        fft_g1(FS, big, in_subgroup=False)
