"""Fused distance -> kernel-sum -> MVM: the CUDA kernels and their plain
PyTorch versions.

Three wrappers over the kernels of `csrc/kmvm.cu` (see the note at its top):

    kmvm_fused       out = [sum_c w_c prod_f phi_cf(q_cf d2(Xi, Xj))] @ V
                     (replaces `repro.kernels.kmvm.kmvm_pallas`)
    kmvm_fused_dots  the same plus the CG dot block
                     [<Kv, v>, <r, v>, <r, r>, <v, v>] per RHS column:
                     kmvm_fused's split launch, whose split-sum kernel
                     also takes the dots
                     (replaces `repro.kernels.kmvm.kmvm_pallas_dots`)
    kmvm_fused_chunk acc += the same product over one chunk of columns,
                     acc updated in place: one step of the distributed
                     engine's ring contraction (replaces
                     `repro.kernels.kmvm.kmvm_pallas_chunk`)

Inputs arrive pre-scaled by the pass's reference lengthscale, V by the
base weight, in the operand dtype (fp32 or bf16); the component structure
is a static tuple of factor-kind tuples and its hyperparameters a flat fp32
scalar vector in `scalar_layout` order. The outputs are fp32 at any
operand dtype: the epilogue and the running sums are IEEE fp32, and the
two products run on the tensor cores in 3xTF32 (fp32 operands split into
two TF32 parts; bf16 operands are exact in TF32), about fp32's accuracy.

Each wrapper dispatches on where its tensors lie: a CPU tensor goes to the
plain version (`kmvm_plain`, `kmvm_dots_plain`, `kmvm_chunk_plain`), a
CUDA tensor to the
kernel — or an exception; nothing falls back. `launch_counts` counts the
kernel launches of each wrapper, so a run can show that its path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.core.kernels_math import kernel_from_sqdist

from . import build

# kind codes shared with csrc/kmvm.cu (enum Kind)
KIND_CODES = {"rbf": 0, "matern12": 1, "matern32": 2, "matern52": 3, "rq": 4,
              "wendland2": 5, "wendland4": 6}
MAX_COMPONENTS = 4
MAX_FACTORS = 4
ROW_TILE = 64        # BM of the kernels: rows per block, rows per dot partial
_COL_TILE = 64       # BN of the kernels
_SPLIT_TILES = 64    # default column tiles per split of B1/B2 (4096 columns)
_PLAIN_ROWS = 1024   # row block of the plain versions

_count_lock = threading.Lock()
launch_counts = {"kmvm": 0, "kmvm_dots": 0, "kmvm_chunk": 0}


def reset_launch_counts() -> None:
    with _count_lock:
        for k in launch_counts:
            launch_counts[k] = 0


def _count(name: str) -> None:
    """One launch of `name`; batcher workers launch from several threads,
    and `+=` on a dict entry is not atomic."""
    with _count_lock:
        launch_counts[name] += 1


def scalar_layout(components: tuple) -> int:
    """Length of the flat scalar vector for a static component tuple:
    per component w_c, then per factor q_cf (+ alpha_cf for rq)."""
    n = 0
    for kinds in components:
        n += 1
        for kind in kinds:
            n += 2 if kind == "rq" else 1
    return n


def _epilogue(components, scalars: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """sum_c w_c prod_f phi_cf(q_cf d2) on an fp32 d2 slab."""
    k = None
    s = 0
    for kinds in components:
        w = scalars[s]
        s += 1
        term = None
        for kind in kinds:
            q = scalars[s]
            s += 1
            if kind == "rq":
                f = kernel_from_sqdist("rq", q * d2, scalars[s])
                s += 1
            else:
                f = kernel_from_sqdist(kind, q * d2)
            term = f if term is None else term * f
        term = w * term
        k = term if k is None else k + term
    return k


def _plain_rows(components, Xi, Xj, V, scalars, i0, i1, xj32, nj, v32):
    """out[i0:i1] of the fused product: one (rows, n) slab at a time."""
    xi32 = Xi[i0:i1].to(torch.float32)
    g = xi32 @ xj32.T
    ni = torch.sum(xi32 * xi32, dim=1, keepdim=True)
    d2 = torch.clamp(ni + nj - 2.0 * g, min=0.0)
    k = _epilogue(components, scalars, d2)
    if Xi.dtype == torch.bfloat16:  # the K @ V operand, as the kernel rounds it
        k = k.to(torch.bfloat16).to(torch.float32)
    return k @ v32


def kmvm_plain(components, Xi, Xj, V, scalars) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel: (m, t) fp32, blocked over
    row tiles so no more than one (rows, n) slab is ever live."""
    xj32 = Xj.to(torch.float32)
    nj = torch.sum(xj32 * xj32, dim=1)[None, :]
    v32 = V.to(torch.float32)
    m = Xi.shape[0]
    out = torch.empty((m, V.shape[1]), dtype=torch.float32, device=Xi.device)
    for i0 in range(0, m, _PLAIN_ROWS):
        i1 = min(i0 + _PLAIN_ROWS, m)
        out[i0:i1] = _plain_rows(components, Xi, Xj, V, scalars, i0, i1,
                                 xj32, nj, v32)
    return out


def kmvm_dots_plain(components, Xi, Xj, V, Vrow, R, scalars):
    """Plain version of the fused-CG kernel: (out (m, t) fp32, dots (4, t)
    fp32) with dots rows [<Kv, v>, <r, v>, <r, r>, <v, v>] from the
    unscaled row views Vrow and R."""
    out = kmvm_plain(components, Xi, Xj, V, scalars)
    vr = Vrow.to(torch.float32)
    r = R.to(torch.float32)
    dots = torch.stack([torch.sum(out * vr, 0), torch.sum(r * vr, 0),
                        torch.sum(r * r, 0), torch.sum(vr * vr, 0)])
    return out, dots


def kmvm_chunk_plain(components, Xi, Xj, V, scalars, acc):
    """Plain version of the chunk step: acc += kmvm_plain(...) in place."""
    acc += kmvm_plain(components, Xi, Xj, V, scalars)
    return acc


# ---------------------------------------------------------------------------
# the CUDA wrappers
# ---------------------------------------------------------------------------


def _spec_array(components) -> ctypes.Array:
    if not 1 <= len(components) <= MAX_COMPONENTS:
        raise ValueError(
            f"the fused kernel takes 1..{MAX_COMPONENTS} components, got "
            f"{len(components)}: {components}")
    vals = [0] * (1 + MAX_COMPONENTS + MAX_COMPONENTS * MAX_FACTORS)
    vals[0] = len(components)
    for c, kinds in enumerate(components):
        if not 1 <= len(kinds) <= MAX_FACTORS:
            raise ValueError(
                f"the fused kernel takes 1..{MAX_FACTORS} factors per "
                f"component, got {kinds}")
        vals[1 + c] = len(kinds)
        for f, kind in enumerate(kinds):
            if kind not in KIND_CODES:
                raise ValueError(f"no fused kernel for kind {kind!r}")
            vals[1 + MAX_COMPONENTS + c * MAX_FACTORS + f] = KIND_CODES[kind]
    return (ctypes.c_int * len(vals))(*vals)


def _check_launch(components, scalars, operands, fp32_rows=()):
    """Raise on anything the kernels do not take; returns the dtype code."""
    Xi, Xj, V = operands
    for name, a in (("Xi", Xi), ("Xj", Xj), ("V", V), ("scalars", scalars),
                    *fp32_rows):
        if a.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {a.device}")
        if a.device != Xi.device:
            raise ValueError(f"{name} is on {a.device}, Xi on {Xi.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Xi.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"operands must be float32 or bfloat16, got {Xi.dtype}")
    if Xj.dtype != Xi.dtype or V.dtype != Xi.dtype:
        raise ValueError(
            f"operand dtypes differ: {Xi.dtype}, {Xj.dtype}, {V.dtype}")
    for name, a in (("scalars", scalars), *fp32_rows):
        if a.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {a.dtype}")
    m, d = Xi.shape
    n, t = V.shape
    if Xj.shape != (n, d):
        raise ValueError(f"shapes differ: Xi {Xi.shape}, Xj {Xj.shape}, V {V.shape}")
    if scalars.shape != (scalar_layout(components),):
        raise ValueError(
            f"scalars {tuple(scalars.shape)} do not match {components}")
    for name, a in fp32_rows:
        if a.shape != (m, t):
            raise ValueError(f"{name} {tuple(a.shape)} != {(m, t)}")
    return 1 if Xi.dtype == torch.bfloat16 else 0


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        msg = build.library().kmvm_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _column_split(m: int, n: int, t: int,
                  split_tiles: int | None = None) -> tuple[int, int]:
    """(nsplit, tiles_per_split) of `kmvm_fused`'s column range.

    The split fills the card when the row tiles alone are too few (a
    1024-row prediction chunk, B2's 1024 row tiles at 2^16 rows). It
    depends on n and `split_tiles` only (None = `_SPLIT_TILES`, 0 = the
    whole column range in one split; `kernels.autotune` picks it per n, d
    and t, never per launch rows), so a row's result is bitwise the same
    whatever the number of rows in the launch (a padded serving chunk and
    an unchunked call agree exactly); only a partial buffer above 1 GiB
    makes it coarser.
    """
    ntiles = -(-n // _COL_TILE)
    per = _SPLIT_TILES if split_tiles is None else (split_tiles or ntiles)
    if per < 1:
        raise ValueError(f"split_tiles must be >= 0 or None, got {split_tiles}")
    while -(-ntiles // per) * m * t * 4 > (1 << 30) and per < ntiles:
        per *= 2
    return -(-ntiles // per), per


def _split_buffer(nsplit, m, t, device):
    """The kernels' scratch for nsplit > 1 partial outputs (nsplit, m, t)
    fp32, which the split-sum kernel adds in split order; None (a null
    pointer) for one split, which writes the output itself. The caller
    holds it until the launch is enqueued."""
    if nsplit == 1:
        return None
    return torch.empty((nsplit, m, t), dtype=torch.float32, device=device)


def _ptr(a):
    return None if a is None else a.data_ptr()


def kmvm_fused(components, Xi, Xj, V, scalars,
               split_tiles: int | None = None) -> torch.Tensor:
    """Fused [sum_c w_c prod_f phi(q d2(Xi, Xj))] @ V -> (m, t) fp32.

    Xi (m, d), Xj (n, d), V (n, t) in one operand dtype (fp32 or bf16);
    scalars (L,) fp32 in `scalar_layout` order. Any m, n, d, t >= 1.
    split_tiles: column tiles per split (`_column_split`); the plain
    version has no split and ignores it.
    """
    if Xi.device.type == "cpu":
        return kmvm_plain(components, Xi, Xj, V, scalars)
    dtype_code = _check_launch(components, scalars, (Xi, Xj, V))
    m, d = Xi.shape
    n, t = V.shape
    if m == 0 or n == 0:
        return torch.zeros((m, t), dtype=torch.float32, device=Xi.device)
    nsplit, per = _column_split(m, n, t, split_tiles)
    out = torch.empty((m, t), dtype=torch.float32, device=Xi.device)
    part = _split_buffer(nsplit, m, t, Xi.device)
    lib = build.library()
    code = lib.kmvm_fwd(
        dtype_code, Xi.data_ptr(), Xj.data_ptr(), V.data_ptr(),
        scalars.data_ptr(), _spec_array(components), scalars.shape[0],
        _ptr(part), out.data_ptr(), m, n, d, t, nsplit, per,
        torch.cuda.current_stream(Xi.device).cuda_stream)
    _raise_on(code, "kmvm")
    _count("kmvm")
    return out


def kmvm_fused_dots(components, Xi, Xj, V, Vrow, R, scalars,
                    split_tiles: int | None = None):
    """The fused-CG step: (out (m, t) fp32, dots (4, t) fp32), dots rows
    [<Kv, v>, <r, v>, <r, r>, <v, v>] per column from the unscaled fp32 row
    views Vrow, R (m, t). No noise term: the caller adds sigma^2. out is
    `kmvm_fused`'s bit for bit at the same `split_tiles` (the same column
    split, summed in split order); each 64-row tile's dots are summed in
    tile order."""
    if Xi.device.type == "cpu":
        return kmvm_dots_plain(components, Xi, Xj, V, Vrow, R, scalars)
    dtype_code = _check_launch(components, scalars, (Xi, Xj, V),
                               fp32_rows=(("Vrow", Vrow), ("R", R)))
    m, d = Xi.shape
    n, t = V.shape
    if m == 0 or n == 0:
        raise ValueError(f"kmvm_fused_dots needs m, n >= 1, got {m}, {n}")
    nsplit, per = _column_split(m, n, t, split_tiles)
    out = torch.empty((m, t), dtype=torch.float32, device=Xi.device)
    part = _split_buffer(nsplit, m, t, Xi.device)
    partials = torch.empty((-(-m // ROW_TILE), 4, t), dtype=torch.float32,
                           device=Xi.device)
    lib = build.library()
    code = lib.kmvm_dots_fwd(
        dtype_code, Xi.data_ptr(), Xj.data_ptr(), V.data_ptr(),
        Vrow.data_ptr(), R.data_ptr(), scalars.data_ptr(),
        _spec_array(components), scalars.shape[0], _ptr(part), out.data_ptr(),
        partials.data_ptr(), m, n, d, t, nsplit, per,
        torch.cuda.current_stream(Xi.device).cuda_stream)
    _raise_on(code, "kmvm_dots")
    _count("kmvm_dots")
    return out, torch.sum(partials, dim=0)


def kmvm_fused_chunk(components, Xi, Xj, V, scalars, acc) -> torch.Tensor:
    """acc += [sum_c w_c prod_f phi(q d2(Xi, Xj))] @ V, in place; returns acc.

    Xi (m, d) rows, Xj (nc, d) and V (nc, t) one chunk of columns, in one
    operand dtype (fp32 or bf16); scalars (L,) and acc (m, t) fp32. One
    launch, no column split: each chunk's product is added to acc in fp32
    in column order, so at t > 1 chunks of whole 64-column tiles walked in
    order give the bits of one `kmvm_fused` launch over their columns
    wherever that launch runs one split (n <= 4096); at t = 1 a single
    chunk does (the final four-lane tree of a row regroups a walk).
    """
    if Xi.device.type == "cpu":
        return kmvm_chunk_plain(components, Xi, Xj, V, scalars, acc)
    dtype_code = _check_launch(components, scalars, (Xi, Xj, V),
                               fp32_rows=(("acc", acc),))
    m, d = Xi.shape
    nc, t = V.shape
    if m == 0 or nc == 0:
        return acc
    lib = build.library()
    code = lib.kmvm_acc_fwd(
        dtype_code, Xi.data_ptr(), Xj.data_ptr(), V.data_ptr(),
        scalars.data_ptr(), _spec_array(components), scalars.shape[0],
        acc.data_ptr(), m, nc, d, t,
        torch.cuda.current_stream(Xi.device).cuda_stream)
    _raise_on(code, "kmvm_chunk")
    _count("kmvm_chunk")
    return acc
