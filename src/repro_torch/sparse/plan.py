"""Sparsity planner: kernel compact support -> a static block mask.

The counterpart of `repro.sparse.plan`. Once a kernel spec is compactly
supported (a Wendland taper factor in every additive term), the kernel
matrix of points ordered along a space-filling curve is block-sparse: a
pair of `tile`-row tiles whose bounding boxes lie farther apart than the
support radius holds exactly zero kernel entries. The plan is host-side
numpy and holds the same arrays as the reference's:

  1. `morton_order` sorts the points along a Morton (z-order) curve;
  2. the sorted points are cut into `tile`-row tiles with bounding boxes;
  3. the box-to-box distance lower-bounds every pairwise distance, so a
     tile pair beyond the planned support is dropped (bitwise exact: the
     Wendland clamp, not a threshold);
  4. the active pairs, sorted by row then column, become the pair list
     (the block-sparse kernel's CSR input) and its row-grouped form.

`SparsePlan.digest` hashes exactly what the reference hashes, so a plan
built here and one built by the reference from the same (kernel, X,
params) have the same digest, and posterior artifacts that record it load
in either package. The support radius enters the digest as the value of
softplus(raw radius) that the reference computes with XLA on an x86-64
CPU, in float32 or float64 as the hyperparameters are; `_softplus_f32` and
`_softplus_f64` repeat that arithmetic bit for bit (numpy's own float64
softplus misses XLA's last bit on two of the five seeded radii of
tests/test_torch_api_surface.py, and then so does the digest; that file
holds seeded float32 and float64 plans' digests against the reference's).

A margin guards the mask against the support radius moving in training:
the plan is built at support * (1 + margin), and `needs_replan` fires
(through `repro_torch.train.solver_state.param_drift`) before the radius
can outgrow it. Specs with an unbounded additive term plan to the
all-active mask.
"""

from __future__ import annotations

import functools
import hashlib
import math
import struct
from fractions import Fraction
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.kernels_math import (
    TAPER_KINDS,
    canonicalize_kernel,
    normalize_components,
    params_map,
    softplus,
)


def morton_order(X, bits_total: int = 30) -> np.ndarray:
    """Permutation sorting rows of X along a Morton (z-order) curve:
    coordinates quantized to `bits_total // d` bits over the bounding box
    and bit-interleaved; a stable argsort keeps it deterministic."""
    X = np.asarray(X, np.float64)
    n, d = X.shape
    b = max(1, bits_total // d)
    lo, hi = X.min(axis=0), X.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    q = np.clip((X - lo) / span * (2**b - 1), 0, 2**b - 1).astype(np.uint64)
    code = np.zeros(n, np.uint64)
    for bit in range(b):
        for j in range(d):
            code |= ((q[:, j] >> np.uint64(bit)) & np.uint64(1)) << \
                np.uint64(bit * d + j)
    return np.argsort(code, kind="stable").astype(np.int32)


# -- the reference's float32 softplus, bit for bit ---------------------------
#
# XLA's CPU backend lowers softplus(x) = max(x, 0) + log1p(exp(-|x|)) to
# its own polynomial exp and log1p, with every multiply that feeds a single
# add contracted into an FMA. The constants below are that code's, as
# float32; `_fma` is a fused multiply-add (the float32 product is exact in
# long double, so one rounding to float32 follows). Results that are
# subnormal flush to zero, as XLA's do.

_F = np.float32
_LD = np.longdouble


def _c(bits: str) -> np.float32:
    return _F(struct.unpack(">d", bytes.fromhex(bits))[0])


def _fma(a, b, c):
    return (np.asarray(a, _F).astype(_LD) * np.asarray(b, _F).astype(_LD)
            + np.asarray(c, _F).astype(_LD)).astype(_F)


def _ftz(x):
    return np.where(np.abs(x) < np.finfo(_F).tiny, _F(0), x).astype(_F)


def _exp_f32(x):
    x = np.clip(x, _c("C055F33340000000"), _c("4056333340000000")).astype(_F)
    fx = np.clip(np.floor(_fma(x, _c("3FF7154760000000"), _F(0.5))),
                 _F(-127), _F(127)).astype(_F)
    r = _fma(-fx, _c("3FE6300000000000"), x)
    r = _fma(-fx, _c("BF2BD01060000000"), r)
    p = _fma(r, _c("3F2A0D2CE0000000"), _c("3F56E879C0000000"))
    for k in ("3F81112100000000", "3FA5553820000000", "3FC5555540000000"):
        p = _fma(p, r, _c(k))
    p = _fma(p, r, _F(0.5))
    y = _fma(p, r * r, r) + _F(1.0)
    scale = ((fx.astype(np.int32) << 23) + 1065353216).astype(np.int32).view(_F)
    return _ftz((y * scale).astype(_F))


def _log_f32(x):
    xc = np.maximum(x, _c("3810000000000000")).astype(_F)
    bits = xc.view(np.int32)
    m = ((bits & 8388607) | 1056964608).astype(np.int32).view(_F)
    small = m < _c("3FE6A09E60000000")
    e = ((bits >> 23) - 127).astype(_F) + _F(1.0) - np.where(small, _F(1), _F(0))
    t = (m + _F(-1.0)) + np.where(small, m, _F(0))
    z = t * t
    z3 = z * t
    a = _fma(_fma(t, _c("3FB2043760000000"), _c("BFBD7A3700000000")), t,
             _c("3FBDE4A340000000"))
    b = _fma(_fma(t, _c("BFBFCBA9E0000000"), _c("3FC23D37E0000000")), t,
             _c("BFC555CA00000000"))
    c = _fma(_fma(t, _c("3FC999D580000000"), _c("BFCFFFFF80000000")), t,
             _c("3FD5555540000000"))
    y = _fma(_fma(_fma(a, z3, b), z3, c), z3, e * _c("BF2BD01060000000"))
    y = _fma(-z, _F(0.5), t) + y
    return _fma(e, _c("3FE6300000000000"), y)


def _log1p_f32(x):
    big = _log_f32(x + _F(1.0))
    x2 = x * x
    z0 = x * _F(0.0)
    num = _fma(z0 + _F(1.0), x, _c("402E2035A0000000"))
    for k in ("4054C30B60000000", "406BB865A0000000", "4073519460000000",
              "406B0DB140000000", "404E0F3040000000"):
        num = _fma(num, x, _c(k))
    den = _fma(z0 + _c("3F07BC0960000000"), x, _c("3FDFE818A0000000"))
    for k in ("401A509F40000000", "403DE97380000000", "404E798EC0000000",
              "404C8E75A0000000", "40340A2020000000"):
        den = _fma(den, x, _c(k))
    small = x + _fma(x2, _F(-0.5), (x * x2) * (den / num))
    return np.where(np.abs(x) < _c("3FDA8279A0000000"), small, big).astype(_F)


def _softplus_f32(x) -> np.ndarray:
    """softplus of float32 values as the reference computes it on the CPU
    (finite inputs; the support radius is never inf or nan)."""
    x = np.asarray(x, _F)
    with np.errstate(all="ignore"):
        out = np.maximum(x, _F(0)) + _log1p_f32(_exp_f32(-np.abs(x)))
    return _ftz(out.astype(_F))


# -- the reference's float64 softplus, bit for bit ---------------------------
#
# In float64 XLA's CPU backend computes exp as Eigen's Cephes rational
# approximation (`pexp_double`) and log1p as Cephes' rational approximation
# below sqrt(2) - 1 and as log(1 + x) above it, where its log is the C
# library's; multiplies that feed an add are contracted into FMAs as in
# float32. `_fma64` is exact: the sum of rationals is rounded once.

_EXP_P = (1.26177193074810590878e-4, 3.02994407707441961300e-2,
          9.99999999999999999910e-1)
_EXP_Q = (3.00198505138664455042e-6, 2.52448340349684104192e-3,
          2.27265548208155028766e-1, 2.00000000000000000009e0)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _fma64(a: float, b: float, c: float) -> float:
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _poly64(x: float, coeffs) -> float:
    """Horner's rule, highest coefficient first, one FMA a step."""
    p = 0.0
    for c in coeffs:
        p = _fma64(p, x, c)
    return p


def _exp_f64(x: float) -> float:
    if x < -745.519:
        return 0.0
    x = min(x, 709.784)
    fx = math.floor(_fma64(1.4426950408889634073599, x, 0.5))
    r = _fma64(-fx, 0.693145751953125, x)
    r = _fma64(-fx, 1.42860682030941723212e-6, r)
    px = _poly64(r * r, _EXP_P) * r
    qx = _poly64(r * r, _EXP_Q)
    return math.ldexp(_fma64(2.0, px / (qx - px), 1.0), fx)


def _log1p_f64(x: float) -> float:
    if abs(x) < 0.41421356237309504880:
        x2 = x * x
        r = (x * x2) * (_poly64(x, _LOG1P_NUM) / _poly64(x, _LOG1P_DEN))
        return x + _fma64(x2, -0.5, r)
    return math.log(x + 1.0)


def _softplus_f64(x: float) -> float:
    return max(x, 0.0) + _log1p_f64(_exp_f64(-abs(x)))


def _softplus_host(raw: np.ndarray) -> np.ndarray:
    if raw.dtype == np.float32:
        return _softplus_f32(raw)
    return np.vectorize(_softplus_f64, otypes=[np.float64])(
        raw.astype(np.float64))


def _taper_terms(kernel, params):
    """Per additive component: the raw radius leaves of its taper factors."""
    spec, kp = canonicalize_kernel(kernel, params)
    return [[p.raw_lengthscale for kind, p in term.factors
             if kind in TAPER_KINDS]
            for term in normalize_components(spec, kp)]


def _host_params(params):
    """The params tree with numpy leaves (a host copy)."""
    return params_map(
        lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
        else np.asarray(a), params)


def support_radius_host(kernel, params) -> float:
    """The spec's compact-support radius in input space as the reference's
    planner computes it (a Python float; inf when a component is
    unbounded): per component the smallest taper radius, then the largest
    over components."""
    params_t = params_map(torch.as_tensor, _host_params(params))
    sup = 0.0
    for radii in _taper_terms(kernel, params_t):
        t_sup = math.inf
        for raw in radii:
            t_sup = min(t_sup, float(_softplus_host(raw.numpy())))
        sup = max(sup, t_sup)
    return sup


def spec_support_radius(kernel, params) -> torch.Tensor:
    """The same radius as a 0-d tensor on the params' device (no host
    sync: `BlockSparseOperator.cross_matvec` prunes query chunks with it)."""
    noise = params.raw_noise
    sup = torch.zeros((), dtype=noise.dtype, device=noise.device)
    for radii in _taper_terms(kernel, params):
        t_sup = torch.full((), math.inf, dtype=noise.dtype, device=noise.device)
        for raw in radii:
            t_sup = torch.minimum(t_sup, softplus(raw))
        sup = torch.maximum(sup, t_sup)
    return sup


class SparsePlan:
    """Static block-sparsity structure (content-hashed).

    Arrays (numpy, host-side), as the reference's:
      perm/inv_perm  (n,)      Morton permutation and its inverse
      box_lo/box_hi  (T, d)    per-tile bounding boxes (real rows only)
      pair_rows/pair_cols (P,) active (row-tile, col-tile) pairs, sorted by
                               row then col
      pair_first     (P,)      1 where a pair starts a new row tile
      row_cols       (T, kmax) per-row active col tiles, 0-padded
      row_valid      (T, kmax) validity mask for row_cols
      row_ptr        (T + 1,)  CSR offsets of each row's pairs (the
                               block-sparse kernel's form of pair_first)
      row_order      (T,)      the row tiles longest first: the kernel's
                               launch order (computed at first use)

    Scalars: n, d, tile, num_tiles, kmax, num_pairs, fill (= P / T^2),
    support (input-space radius at the planning params; inf = all-active),
    support_planned (= support * (1 + margin)), margin. `params_ref` is the
    host copy of the planning hyperparameters (`needs_replan` measures
    drift against it).
    """

    def __init__(self, *, n, d, tile, perm, inv_perm, box_lo, box_hi,
                 pair_rows, pair_cols, pair_first, row_cols, row_valid,
                 support, support_planned, margin, params_ref):
        self.n = int(n)
        self.d = int(d)
        self.tile = int(tile)
        self.num_tiles = box_lo.shape[0]
        self.perm = perm
        self.inv_perm = inv_perm
        self.box_lo = box_lo
        self.box_hi = box_hi
        self.pair_rows = pair_rows
        self.pair_cols = pair_cols
        self.pair_first = pair_first
        self.row_cols = row_cols
        self.row_valid = row_valid
        self.row_ptr = np.concatenate(
            [[0], np.cumsum(np.bincount(pair_rows, minlength=self.num_tiles))]
        ).astype(np.int32)
        self.kmax = int(row_cols.shape[1])
        self.num_pairs = int(pair_rows.shape[0])
        self.fill = self.num_pairs / float(self.num_tiles**2)
        self.support = float(support)
        self.support_planned = float(support_planned)
        self.margin = float(margin)
        self.params_ref = params_ref
        h = hashlib.sha1()
        h.update(np.asarray([self.n, self.d, self.tile], np.int64).tobytes())
        h.update(np.float64([self.support_planned]).tobytes())
        h.update(perm.tobytes())
        h.update(pair_rows.tobytes())
        h.update(pair_cols.tobytes())
        self.digest = h.hexdigest()

    @functools.cached_property
    def row_order(self) -> np.ndarray:
        """(T,) int32: the row tiles longest first (descending CSR degree,
        ties in plan order), the block-sparse kernel's launch order;
        computed once per plan."""
        from .kmvm_sparse import longest_row_first

        return longest_row_first(self.row_ptr)

    @property
    def n_pad(self) -> int:
        return self.num_tiles * self.tile

    @property
    def compact(self) -> bool:
        return math.isfinite(self.support)

    @property
    def entries(self) -> int:
        """Kernel entries one MVM evaluates: the active pairs' real rows
        times their real columns (the ragged last tile counted as it is)."""
        sizes = np.minimum(self.tile, self.n - np.arange(self.num_tiles) *
                           self.tile).astype(np.int64)
        return int(np.sum(sizes[self.pair_rows] * sizes[self.pair_cols]))

    def __hash__(self):
        return hash(self.digest)

    def __eq__(self, other):
        return isinstance(other, SparsePlan) and self.digest == other.digest

    def __repr__(self):
        return (f"SparsePlan(n={self.n}, tile={self.tile}, "
                f"tiles={self.num_tiles}, pairs={self.num_pairs}, "
                f"fill={self.fill:.3f}, support={self.support:.4g})")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_plan(kernel, X, params, *, tile: int = 256, margin: float = 0.1,
               assume_sorted: bool = False) -> SparsePlan:
    """Host-side planning: (kernel, X, params) -> SparsePlan.

    X and params may be tensors on any device or numpy arrays (they are
    copied to the host). `tile` is clamped to the dataset and rounded to a
    multiple of 8, as the reference's; `margin` widens the planned support
    for `needs_replan`; `assume_sorted=True` keeps the identity order.
    """
    if isinstance(X, torch.Tensor):
        X = X.detach().cpu().numpy()
    Xh = np.asarray(X, np.float64)
    n, d = Xh.shape
    tile = max(8, min(_round_up(tile, 8), _round_up(n, 8)))
    perm = (np.arange(n, dtype=np.int32) if assume_sorted
            else morton_order(Xh))
    inv_perm = np.empty(n, np.int32)
    inv_perm[perm] = np.arange(n, dtype=np.int32)
    Xs = Xh[perm]

    T = -(-n // tile)
    box_lo = np.empty((T, d), np.float64)
    box_hi = np.empty((T, d), np.float64)
    for t in range(T):
        blk = Xs[t * tile:min((t + 1) * tile, n)]
        box_lo[t] = blk.min(axis=0)
        box_hi[t] = blk.max(axis=0)

    params_ref = _host_params(params)
    support = support_radius_host(kernel, params_ref)
    if math.isfinite(support):
        support_planned = support * (1.0 + margin)
        # box-to-box distance lower-bounds every pairwise distance
        gap = np.maximum(box_lo[:, None, :] - box_hi[None, :, :], 0.0)
        gap = np.maximum(gap, np.maximum(
            box_lo[None, :, :] - box_hi[:, None, :], 0.0))
        dist = np.sqrt(np.sum(gap * gap, axis=-1))
        mask = dist < support_planned
    else:
        support_planned = math.inf
        mask = np.ones((T, T), bool)

    pair_rows, pair_cols = np.nonzero(mask)  # row-major: sorted by row, col
    pair_rows = pair_rows.astype(np.int32)
    pair_cols = pair_cols.astype(np.int32)
    pair_first = np.zeros(pair_rows.shape[0], np.int32)
    pair_first[np.searchsorted(pair_rows, np.arange(T))] = 1

    counts = np.bincount(pair_rows, minlength=T)
    kmax = int(counts.max())
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(pair_rows.shape[0]) - starts[pair_rows]
    row_cols = np.zeros((T, kmax), np.int32)
    row_valid = np.zeros((T, kmax), bool)
    row_cols[pair_rows, slot] = pair_cols
    row_valid[pair_rows, slot] = True

    plan = SparsePlan(
        n=n, d=d, tile=tile, perm=perm, inv_perm=inv_perm,
        box_lo=np.asarray(box_lo, np.float32),
        box_hi=np.asarray(box_hi, np.float32),
        pair_rows=pair_rows, pair_cols=pair_cols, pair_first=pair_first,
        row_cols=row_cols, row_valid=row_valid,
        support=support, support_planned=support_planned, margin=margin,
        params_ref=params_ref)
    # the sparse backend's MVM cost is its fill ratio: surface it beside the
    # solver counters, as the reference does
    obs.counter("sparse.plans_built").inc()
    obs.gauge("sparse.fill").set(plan.fill)
    obs.gauge("sparse.active_pairs").set(plan.num_pairs)
    obs.instant("sparse_plan", n=plan.n, tile=plan.tile,
                pairs=plan.num_pairs, fill=plan.fill)
    return plan


class ChunkSlicedPlan(NamedTuple):
    """`SparsePlan.row_cols` sliced by global vector chunk, the distributed
    engine's view of a plan on a mesh: entry [r, c, :] lists the IN-CHUNK
    col-tile indices active against row tile r (ascending), `valid` the
    occupancy; `kmax` is the max per-(row, chunk) degree."""

    cols: np.ndarray   # (T, n_chunks, kmax) int32 in-chunk col-tile ids
    valid: np.ndarray  # (T, n_chunks, kmax) bool
    kmax: int


@functools.lru_cache(maxsize=32)
def chunk_sliced_plan(plan: SparsePlan, n_chunks: int) -> ChunkSlicedPlan:
    """Slice plan.row_cols by vector chunk (cached on the plan digest).
    Requires whole tiles per chunk."""
    T = plan.num_tiles
    if T % n_chunks:
        raise ValueError(
            f"plan tiles ({T}) must divide the chunk grid ({n_chunks}); "
            f"build the geometry with tile_multiple=plan.tile")
    t_chunk = T // n_chunks
    counts = np.zeros((T, n_chunks), np.int64)
    cid = plan.row_cols // t_chunk
    for r in range(T):
        sel = cid[r][plan.row_valid[r]]
        np.add.at(counts[r], sel, 1)
    kmax = max(int(counts.max()), 1)
    cols = np.zeros((T, n_chunks, kmax), np.int32)
    valid = np.zeros((T, n_chunks, kmax), bool)
    fill = np.zeros((T, n_chunks), np.int64)
    for r in range(T):
        for c, v in zip(plan.row_cols[r], plan.row_valid[r]):
            if not v:
                continue
            ch, k = int(c) // t_chunk, fill[r, int(c) // t_chunk]
            cols[r, ch, k] = int(c) % t_chunk
            valid[r, ch, k] = True
            fill[r, ch] += 1
    return ChunkSlicedPlan(cols=cols, valid=valid, kmax=kmax)


def needs_replan(plan: SparsePlan, params, threshold: float | None = None,
                 kernel=None):
    """(replan?, drift): drift is `param_drift` of the constrained
    hyperparameters since the plan's params; a replan fires when it exceeds
    `threshold` (default: the plan's margin) or, with `kernel`, whenever the
    current support radius has outgrown the planned one. All-active plans
    never need one."""
    from repro_torch.train.solver_state import param_drift

    drift = param_drift(plan.params_ref, params)
    if not plan.compact:
        return False, drift
    thr = plan.margin if threshold is None else threshold
    if drift > thr:
        return True, drift
    if kernel is not None and not plan_is_safe(plan, kernel, params):
        return True, drift
    return False, drift


def plan_is_safe(plan: SparsePlan, kernel, params) -> bool:
    """True while the mask provably covers the current support radius."""
    if not plan.compact:
        return True
    return support_radius_host(kernel, params) <= plan.support_planned
