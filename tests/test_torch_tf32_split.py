"""The tensor-core arithmetic of the dense kernels B1-B3, emulated on the CPU.

On the card (`src/repro_torch/kernels/csrc/kmvm.cu`) the cross term
G = Xi Xj^T and, at t > 1, K @ V are TF32 `mma.sync` products: an fp32
operand a is split into big = tf32(a) and small = tf32(a - big), rounded by
`cvt.rna` (to 10 mantissa bits, ties away from zero), and each product is
small*big + big*small + big*big in an fp32 accumulator, one k8 (or k4) step
of the features or of the chunk's columns at a time; a later feature stage's
G and each 64-column chunk's K @ V start from zero and are added in fp32.
These tests emulate that in torch (the rounding by bit masking) and hold it
to a float64 reference computed with the reference package's kernel
functions, within the kernels' tolerance (2e-4 of max|out|), at the smoke's
shapes cut to CPU size. The emulation rounds every fp32 sum to nearest;
the tensor cores truncate what they add into their accumulator, which is
why the kernel restarts each stage and chunk from zero, and that part is
held on the card. They also replay, lane by lane, the fragment
layouts the kernel relies on (m16n8k8 and m16n8k4 of the PTX ISA): the
cross term and the squared norms read from the fragments, and the column
permutation that lets the C fragment of G's epilogue be the A fragment of
K @ V. None of this needs a card; the kernels themselves are held to their
plain versions on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kernels_math import kernel_from_sqdist as ref_kernel_from_sqdist
from repro_torch.kernels import kmvm

TOL = 2e-4  # the kernels' fp32 tolerance, relative to max|out|

# the five kernel kinds of the GPU tests: (components, scalars)
SPECS = {
    "matern32": ((("matern32",),), [1.3, 1.0]),
    "rbf": ((("rbf",),), [0.8, 1.0]),
    "rq": ((("rq",),), [1.1, 1.0, 2.5]),
    "wendland2": ((("wendland2",),), [1.0, 0.05]),
    "0.5*rbf + matern32": ((("rbf",), ("matern32",)), [1.0, 1.0, 2.0, 0.6]),
}


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """`cvt.rna.tf32.f32`: fp32 rounded to 10 mantissa bits, ties away from
    zero (add half a TF32 unit to the magnitude bits, clear the low 13)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of one k-step as three TF32 products into fp32, in the order the
    kernel issues them: small*big, big*small, big*big."""
    ah, al = split(a)
    bh, bl = split(b)
    acc = al @ bh
    acc = acc + ah @ bl
    return acc + ah @ bh


def feature_steps(d: int) -> list:
    """The kernel's feature stages for d, each a list of (first feature,
    depth) k-steps: one stage of a k4 step (d <= 4), a k8 and a k4 step
    (d <= 12) or two k8 steps (d <= 16); above, stages of two k8 steps."""
    if d <= 4:
        return [[(0, 4)]]
    if d <= 12:
        return [[(0, 8), (8, 4)]]
    return [[(k0, 8), (k0 + 8, 8)] for k0 in range(0, d, 16)]


def emulated_kmvm(components, scalars, Xi, Xj, V):
    """The kernel's arithmetic in torch: (m, t) fp32."""
    d = Xi.shape[1]
    pad = -d % 16
    xi = torch.nn.functional.pad(Xi, (0, pad))
    xj = torch.nn.functional.pad(Xj, (0, pad))
    g = None
    for stage in feature_steps(d):
        gs = None
        for k0, w in stage:
            p = mm3(xi[:, k0:k0 + w], xj[:, k0:k0 + w].T)
            gs = p if gs is None else gs + p
        g = gs if g is None else g + gs
    ni = torch.sum(Xi * Xi, dim=1, keepdim=True)
    nj = torch.sum(Xj * Xj, dim=1)[None, :]
    d2 = torch.clamp(ni + nj - 2.0 * g, min=0.0)
    K = kmvm._epilogue(components, torch.tensor(scalars, dtype=torch.float32), d2)
    t = V.shape[1]
    if t == 1:  # fp32 row sums on CUDA cores
        return K @ V
    acc = torch.zeros((Xi.shape[0], t), dtype=torch.float32)
    for j0 in range(0, V.shape[0], 64):  # each chunk from zero, then added
        part = None
        for k0 in range(j0, min(j0 + 64, V.shape[0]), 8):
            p = mm3(K[:, k0:k0 + 8], V[k0:k0 + 8])
            part = p if part is None else part + p
        acc = acc + part
    return acc


def reference_kmvm(components, scalars, Xi, Xj, V) -> np.ndarray:
    """float64: exact squared distances, the reference package's kernel
    functions, then K @ V."""
    xi, xj = Xi.double().numpy(), Xj.double().numpy()
    d2 = np.maximum((xi * xi).sum(1)[:, None] + (xj * xj).sum(1)[None, :]
                    - 2.0 * xi @ xj.T, 0.0)
    d2 = jnp.asarray(d2, dtype=jnp.float64)
    K, s = 0.0, 0
    for kinds in components:
        term = scalars[s]
        s += 1
        for kind in kinds:
            q = scalars[s]
            s += 1
            if kind == "rq":
                term = term * ref_kernel_from_sqdist("rq", q * d2, scalars[s])
                s += 1
            else:
                term = term * ref_kernel_from_sqdist(kind, q * d2)
        K = K + term
    return np.asarray(K, dtype=np.float64) @ V.double().numpy()


def _inputs(m, n, d, t, seed):
    rng = np.random.default_rng(seed)
    scale = 2.0 / np.sqrt(d)

    def arr(*shape, s=1.0):
        return torch.as_tensor(s * rng.standard_normal(shape), dtype=torch.float32)

    return arr(m, d, s=scale), arr(n, d, s=scale), arr(n, t)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # a TF32 unit at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0, -0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 3.0, -0.0])
    assert torch.equal(tf32_rna(x), want)
    r = tf32_rna(torch.randn(1000, generator=torch.Generator().manual_seed(0)))
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)


def test_split_is_exact_to_tf32_squared():
    x = torch.randn(10000, generator=torch.Generator().manual_seed(1)) * 100
    big, small = split(x)
    resid = (x.double() - big.double() - small.double()).abs()
    assert torch.all(resid <= 2.0 ** -21 * x.double().abs())
    # the product: small*small and the rounding of small are all it drops
    y = torch.randn(10000, generator=torch.Generator().manual_seed(2))
    yb, ys = split(y)
    p3 = (small * yb).double() + (big * ys).double() + (big * yb).double()
    exact = x.double() * y.double()
    assert torch.all((p3 - exact).abs() <= 2.0 ** -20 * exact.abs() + 1e-30)


def test_bf16_values_are_exact_in_tf32():
    """bf16 operands need no split: one TF32 product is exact."""
    x = torch.randn(10000, generator=torch.Generator().manual_seed(3))
    xb = x.to(torch.bfloat16).to(torch.float32)
    assert torch.equal(tf32_rna(xb), xb)


@pytest.mark.parametrize("t", (1, 9, 128))
@pytest.mark.parametrize("d", (2, 9, 385))
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_emulated_3xtf32_within_kernel_tolerance_of_fp64(spec, d, t):
    """The emulated kernel (3xTF32 cross term, fp32 norms and epilogue,
    3xTF32 K @ V at t > 1) against float64, at the smoke's d and t with
    m = 130, n = 1000 (ragged, 16 column chunks). Each case states its
    margin: error / (2e-4 max|out|)."""
    components, scalars = SPECS[spec]
    Xi, Xj, V = _inputs(130, 1000, d, t, seed=d + t)
    out = emulated_kmvm(components, scalars, Xi, Xj, V).double().numpy()
    ref = reference_kmvm(components, scalars, Xi, Xj, V)
    margin = np.max(np.abs(out - ref)) / (TOL * np.max(np.abs(ref)))
    print(f"{spec} d={d} t={t}: margin {margin:.4f}")
    assert margin <= 1.0, f"{spec} d={d} t={t}: margin {margin:.4f}"
    # the plain fp32 version, for scale: both well inside the tolerance
    plain = kmvm.kmvm_plain(components, Xi, Xj, V,
                            torch.tensor(scalars, dtype=torch.float32))
    plain_margin = np.max(np.abs(plain.double().numpy() - ref)) / (
        TOL * np.max(np.abs(ref)))
    assert plain_margin <= 1.0, plain_margin


# ---------------------------------------------------------------------------
# fragment layouts, lane by lane (PTX ISA, mma.m16n8k8 / m16n8k4 .tf32)
# ---------------------------------------------------------------------------

LANES = range(32)


def _gid_tig(lane):
    return lane // 4, lane % 4


def _mma(a, b, c, k):
    """One warp-wide mma.m16n8k{8,4}: per-lane fragments in, per-lane
    fragments of D = A B + C out (float64, exact for these values)."""
    A = np.full((16, k), np.nan)
    B = np.full((k, 8), np.nan)
    C = np.full((16, 8), np.nan)
    for lane in LANES:
        gid, tig = _gid_tig(lane)
        for i, v in enumerate(a[lane]):  # A: rows gid (+8), columns tig (+4)
            A[gid + 8 * (i & 1), tig + 4 * (i >> 1)] = v
        for i, v in enumerate(b[lane]):  # B: rows tig (+4), column gid
            B[tig + 4 * i, gid] = v
        for i, v in enumerate(c[lane]):  # C: rows gid (+8), columns 2tig (+1)
            C[gid + 8 * (i >> 1), 2 * tig + (i & 1)] = v
    assert not (np.isnan(A).any() or np.isnan(B).any() or np.isnan(C).any())
    D = A @ B + C
    return [[D[gid + 8 * (i >> 1), 2 * tig + (i & 1)] for i in range(4)]
            for gid, tig in map(_gid_tig, LANES)]


def _sum4(vals):
    """`sum4`: the xor-1 then xor-2 shuffle tree over the lanes of a quad."""
    s1 = [vals[lane] + vals[lane ^ 1] for lane in LANES]
    return [s1[lane] + s1[lane ^ 2] for lane in LANES]


@pytest.mark.parametrize("dk", (4, 12, 16))
def test_cross_term_and_norms_from_fragments(dk):
    """One warp's 16 rows against a 64-column chunk, as `row_tile_tc` reads
    them: Xi fragments per k8 step (features 8ks + tig, + 4) and the k4 step
    (feature 8KS + tig), Xj fragments of n8 tile nn (column 8nn + gid), the
    mma's C tiles gathered back, and the norms from the same values: lane
    partials, the quad tree, then the shuffles from lanes 8tig and 8tig + 4
    that give each lane the norms of its columns 2tig, 2tig + 1."""
    rng = np.random.default_rng(dk)
    xi = rng.standard_normal((16, dk))
    xj = rng.standard_normal((64, dk))
    ks8, k4 = dk // 8, dk % 8 == 4
    G = np.zeros((16, 64))
    pc = {nn: [0.0] * 32 for nn in range(8)}
    for nn in range(8):
        c = [[0.0] * 4 for _ in LANES]
        for ks in range(ks8):
            a = [[xi[g, 8 * ks + t], xi[g + 8, 8 * ks + t], xi[g, 8 * ks + t + 4],
                  xi[g + 8, 8 * ks + t + 4]] for g, t in map(_gid_tig, LANES)]
            b = [[xj[8 * nn + g, 8 * ks + t], xj[8 * nn + g, 8 * ks + t + 4]]
                 for g, t in map(_gid_tig, LANES)]
            c = _mma(a, b, c, 8)
            for lane in LANES:
                pc[nn][lane] += b[lane][0] ** 2 + b[lane][1] ** 2
        if k4:
            a = [[xi[g, 8 * ks8 + t], xi[g + 8, 8 * ks8 + t]]
                 for g, t in map(_gid_tig, LANES)]
            b = [[xj[8 * nn + g, 8 * ks8 + t]] for g, t in map(_gid_tig, LANES)]
            c = _mma(a, b, c, 4)
            for lane in LANES:
                pc[nn][lane] += b[lane][0] ** 2
        for lane in LANES:
            g, t = _gid_tig(lane)
            for i in range(4):
                G[g + 8 * (i >> 1), 8 * nn + 2 * t + (i & 1)] = c[lane][i]
        nj = _sum4(pc[nn])
        for lane in LANES:
            _, t = _gid_tig(lane)
            col = 8 * nn + 2 * t
            assert np.isclose(nj[8 * t], xj[col] @ xj[col], rtol=1e-12)
            assert np.isclose(nj[8 * t + 4], xj[col + 1] @ xj[col + 1], rtol=1e-12)
    np.testing.assert_allclose(G, xi @ xj.T, rtol=1e-12, atol=1e-12)
    # the rows' norms: features tig, tig + 4 per k8 step (and 8KS + tig)
    pn = [[0.0, 0.0] for _ in LANES]
    for lane in LANES:
        g, t = _gid_tig(lane)
        feats = [8 * ks + t + 4 * h for ks in range(ks8) for h in (0, 1)]
        feats += [8 * ks8 + t] if k4 else []
        pn[lane] = [sum(xi[g, f] ** 2 for f in feats),
                    sum(xi[g + 8, f] ** 2 for f in feats)]
    for r in (0, 1):
        ni = _sum4([pn[lane][r] for lane in LANES])
        for lane in LANES:
            g, _ = _gid_tig(lane)
            row = g + 8 * r
            assert np.isclose(ni[lane], xi[row] @ xi[row], rtol=1e-12)


@pytest.mark.parametrize("no", (1, 2, 16))
@pytest.mark.parametrize("seed", (0, 1))
def test_c_fragment_is_the_a_fragment_under_column_permutation(no, seed):
    """K @ V from K's C fragments: the k8 step nn takes tile nn's values
    (rows gid, gid + 8 x columns 2tig, 2tig + 1) as its A fragment with k
    slot tig <- column 2tig and slot tig + 4 <- column 2tig + 1, and V's
    B fragment as rows 8nn + 2tig and + 1 of output column 8o + gid (one
    8-byte load). The permuted sum equals the plain K @ V."""
    rng = np.random.default_rng(seed)
    K = rng.random((16, 64))
    V = rng.standard_normal((64, 8 * no))
    kc = [[[K[g + 8 * (i >> 1), 8 * nn + 2 * t + (i & 1)] for i in range(4)]
           for nn in range(8)] for g, t in map(_gid_tig, LANES)]
    out = np.zeros((16, 8 * no))
    for o in range(no):
        c = [[0.0] * 4 for _ in LANES]
        for nn in range(8):
            a = [[k[nn][0], k[nn][2], k[nn][1], k[nn][3]] for k in kc]
            b = [[V[8 * nn + 2 * t, 8 * o + g], V[8 * nn + 2 * t + 1, 8 * o + g]]
                 for g, t in map(_gid_tig, LANES)]
            c = _mma(a, b, c, 8)
        for lane in LANES:
            g, t = _gid_tig(lane)
            for i in range(4):
                out[g + 8 * (i >> 1), 8 * o + 2 * t + (i & 1)] = c[lane][i]
    np.testing.assert_allclose(out, K @ V, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", (1, 64, 4096, 4097, 20000, 1 << 17))
def test_b2_column_split_depends_on_n_only(n):
    """B2 launches B1's column split (`_column_split`) and sums the splits
    in split order: for a given n the split is the same at every m (up to
    the 1 GiB cap of the partial buffer), so a row's output and its dots'
    terms do not depend on the rows in the launch."""
    splits = {kmvm._column_split(m, n, t) for m in (1, 64, 1000, 1 << 16)
              for t in (1, 9)}
    assert len(splits) == 1
    nsplit, per = splits.pop()
    ntiles = -(-n // 64)
    assert nsplit == -(-ntiles // per) and per == 64
