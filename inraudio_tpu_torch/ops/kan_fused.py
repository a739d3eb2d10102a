"""KAN stack forward (kernel G) and backward (kernel H): the CUDA kernels,
their plain PyTorch versions, and the autograd Function that joins them.

Port of ``inraudio_tpu/ops/pallas_kan.py``: ``_kan_kernel`` becomes
``KAN_FWD`` and ``_kan_bwd_kernel`` becomes ``KAN_BWD`` (both in
``csrc/kan.cu``), with ``kan_forward_plain`` / ``kan_backward_plain`` beside
them, and ``fused_kan_apply`` is a ``torch.autograd.Function`` whose forward
is G and whose backward is H, as ``_fused_kan_flat`` and its custom VJP are.

Each layer crosses the kernels as its knot grid (in, n_knots) and W^T =
cat([base_w[..., None], spline_w * spline_scaler[..., None]], -1) reshaped
to (out, in * J), J = 1 + n_coef.  That flattening is plain differentiable
torch outside the Function, so autograd carries the gradients of spline_w
and spline_scaler as the JAX package differentiates its flatten; the grid
gets a zero gradient.  The Function keeps each layer's input from the
forward for the backward (the TPU kernel recomputed it per tile).

Every product takes the f32 tier of ``INRAUDIO_F32_PRECISION`` (default
bf16x3), as the JAX kernels' ``_kernel_dot`` with compute_dtype float32
does, in the forward and in both backward products.  Not ported, as TPU
artefacts: the first layer's lane padding to 8 inputs, the final layer's
128-lane output padding, the list-of-arrays bases, the row-tile pickers and
the VMEM gate that sends stacks of h >= 512 to XLA autodiff (H here takes
every width).

The kernels take spline orders 1..8 and up to 128 knots a feature
(grid_size + 2 * order <= 127) from two builds of ``csrc/kan.cu``: the
default library for orders up to 4 with at most 16 degree-0 bases (the
runner's KAN, grid 5, order 3) and the wide one (``-DKAN_WIDE=1``) for the
rest (``kan_library``); a config past that bound raises.

The wrappers run the plain versions for CPU tensors only; a CUDA tensor
launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any

import torch

from ..models.kan import KANConfig, _scaled_spline_weight, b_splines
from ..utils.observability import counter
from ._nvcc import LaunchCounter, build_library
from .siren_fused import _MODE_CODE, _check_tensor, _f32_dot_mode, _kernel_dot
from .siren_train import _check_rc

Params = dict[str, Any]

# shapes the kernels take (csrc/kan.cu): the default library's, and the
# wide library's bound
_MAX_BASES = 16          # degree-0 bases per feature (n_knots - 1)
_MAX_ORDER = 4
_KNOT_STRIDE = 20        # floats per feature's knot row in shared memory
_WIDE_MAX_ORDER = 8
_WIDE_MAX_KNOTS = 128    # the wide library's knot row: n_knots floats
# shared memory per CTA the plans stay within: two CTAs fit on an SM
_SMEM_BUDGET = 110 * 1024
_DX_TM, _DX_TN = 32, 256
# CTAs the dW launch aims for: 8 waves of one CTA per SM on 132 SMs
_TARGET_CTAS = 1056
# device memory for one dW launch's per-slice partial sums; more slices go
# through in groups that fold into the same fixed-order sum
SCRATCH_BYTES = 1 << 30


def kan_dot_mode() -> str:
    """The f32 tier of every KAN product: INRAUDIO_F32_PRECISION (default
    bf16x3); anything but bf16x3 / bf16x2 / bf16 is 'highest'."""
    mode = _f32_dot_mode()
    return mode if mode in ("bf16x3", "bf16x2", "bf16") else "highest"


# ---------------------------------------------------------------------------
# Launch plans (the shared-memory formulas of csrc/kan.cu)
# ---------------------------------------------------------------------------

def is_wide(order: int, n_knots: int) -> bool:
    """Whether a config needs the wide library: an order above 4 or more
    than 16 degree-0 bases."""
    return order > _MAX_ORDER or n_knots - 1 > _MAX_BASES


def knot_stride(order: int, n_knots: int) -> int:
    """Floats per feature's knot row in shared memory (kan.cu knot_row)."""
    return n_knots if is_wide(order, n_knots) else _KNOT_STRIDE


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def _ld(inner: int) -> int:
    return inner if inner % 8 else inner + 4


def _col_groups(width: int, cap: int) -> int:
    """Column groups of 8 for a ``width``-wide output: the smallest power
    of two that covers it, at most ``cap``."""
    cg = 1
    while cg * 8 < width and cg < cap:
        cg *= 2
    return cg


# H's tensor-core kernel (csrc/kan.cu): K values per tile, rows per chunk;
# the narrow kernels' feature lanes (at most, in the wide library) and row
# groups, and the A values per block of the grid that sets their slices
_TC_TK, _TC_RC = 64, 32
# its pass with dx fused (kan.cu kan_bwd_ws_kernel): g's stages, A^T and GX
# buffers
_WS_STAGES, _WS_BUFS = 3, 2
_NW_F, _NW_RG, _NW_JB = 32, 8, 16
# the tensor-core dx (kan.cu kan_dx_tc_kernel): its row tiles, W's outputs
# a slab, K values a chunk at most, W's stages, and a chunk's cost beside
# its K values in the plan (the GX park and the contraction)
_DX_TC_TMS, _DX_OC, _DX_NC, _DX_STAGES, _DX_CHUNK = (64, 32), 64, 128, 3, 16
# G's kernels: threads a CTA (the narrow kernel's rows, one a thread); the
# tensor-core kernel's rows a tile and most features a chunk; the narrow
# kernel's features a chunk
_THREADS = 256
_FW_TM = 64
_FW_MAX_FC = 2 * _THREADS // _FW_TM   # kFwPairs * kThreads / kFwTM
_NF_FC = 32
_SMEM_MAX = 232448       # bytes a block may use on the H100
_TC_MODES = ("bf16", "bf16x2", "bf16x3")
# the wide build's tensor-core G (kan.cu under KAN_WIDE): A buffers, W's
# ring of k16 blocks, builder warps (beside 8 mma warps), (row, feature)
# slots a chunk, K values a chunk at most (one mask bit a k16 block); a
# chunk's cost beside its k16 steps in the plan (at J = 24, 104, 11 and 14
# the chunk this cost picks read fastest on an H100: PR 16)
_FWS_BUFS, _FWS_STAGES, _FWS_BUILD_WARPS = 2, 6, 8
_FWS_SLOTS, _FWS_MAX_K, _FWS_CHUNK = 8 * _FW_TM, 512, 2


def layer_route(dout: int, mode: str) -> str:
    """G's and H's route for a layer: 'tc' (tensor cores, dout >= 8) or
    'narrow' (dout < 8) in the bf16 tiers, 'fma' (CUDA-core FMAs) in the
    highest."""
    if mode not in _TC_MODES:
        return "fma"
    return "tc" if dout >= 8 else "narrow"


def _pow2_at_least(v: int, lo: int, hi: int) -> int:
    t = lo
    while t < v and t < hi:
        t *= 2
    return t


def _round16(v: int) -> int:
    return (v + 15) // 16 * 16


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """G's launch for one layer: its route (``layer_route``), its column
    tile (tc: columns, 64..256; narrow: outputs held, >= dout; fma: column
    groups of 8), input features per chunk, rows per tile."""

    route: str
    tile: int
    fc: int
    tm: int


def fwd_tc_smem(tn: int, fc: int, J: int, ks: int = _KNOT_STRIDE) -> int:
    """Dynamic shared memory of the tensor-core G (kan.cu fwd_tc_smem): two
    buffers of A's bf16 planes, two stages of W's, two of knots (rows of
    ``ks`` floats)."""
    kcp = _round16(fc * J)
    return (2 * 2 * _FW_TM * (kcp + 8) * 2 + 2 * 2 * kcp * (tn + 8) * 2
            + 2 * fc * ks * 4)


def fwd_narrow_smem(no: int, J: int, fc: int = _NF_FC,
                    ks: int = _KNOT_STRIDE) -> int:
    """Dynamic shared memory of the narrow G (kan.cu fwd_narrow_smem): the
    rows' inputs, W's f32 planes and the knots of a chunk of ``fc``
    features."""
    return 4 * (_THREADS * (_NF_FC + 1) + 2 * fc * J * no + fc * ks)


def _fc_steps(din: int, fc: int, J: int) -> int:
    """k16 steps of the tensor-core G over din features in chunks of fc
    (each chunk's K padded to a multiple of 16)."""
    full, last = divmod(din, fc)
    return full * _round16(fc * J) // 16 + _round16(last * J) // 16


# the tensor-core G's chunk cost, in k16 steps of its product: a round of
# the A build (one (row, feature) pair a thread) weighs 8, a chunk's
# barrier 2.  At the runner's layer 1 the build takes about twice the
# product's time, and 8 features a chunk (two rounds of 256 pairs, 160
# steps) beat 7 (two rounds, the second a quarter full; 147 steps) by 6%
# on an H100 (PR 8).
_FW_ROUND, _FW_CHUNK = 8, 2


def _fc_cost(din: int, fc: int, J: int) -> int:
    chunks = [min(fc, din - f0) for f0 in range(0, din, fc)]
    rounds = sum(-(-_FW_TM * nf // _THREADS) for nf in chunks)
    return (_fc_steps(din, fc, J) + _FW_ROUND * rounds
            + _FW_CHUNK * len(chunks))


def fwd_ws_smem(tn: int, fc: int, J: int, ks: int) -> int:
    """Dynamic shared memory of the wide build's tensor-core G (kan.cu
    fwd_ws_smem): _FWS_BUFS buffers of A's bf16 planes, a ring of
    _FWS_STAGES k16 blocks of W's two bf16 planes, two buffers of knots
    (rows of ``ks`` floats), the mbarriers, the builders' mask words and
    the slots' previous intervals."""
    return (_FWS_BUFS * 2 * _FW_TM * (_round16(fc * J) + 8) * 2
            + _FWS_STAGES * 2 * 16 * (tn + 8) * 2 + 2 * fc * ks * 4
            + (2 * _FWS_BUFS + 2 * _FWS_STAGES) * 8
            + _FWS_BUFS * _FWS_BUILD_WARPS * 4 + _FWS_BUFS * _FWS_SLOTS * 2)


def _fws_cost(din: int, fc: int, J: int) -> int:
    return _fc_steps(din, fc, J) + _FWS_CHUNK * -(-din // fc)


def _fwd_ws_fc(din: int, dout: int, J: int, ks: int, tile: int) -> int:
    """Input features a chunk of the wide build's tensor-core G.  Where the
    default build takes the config (its knot row is the wide build's
    n_knots floats, so the order is ks - J), the default build's chunk: the
    same padding and k16 blocks, so the two builds sum every output in one
    order.  Past that, the chunk of least ``_fws_cost`` within shared
    memory, _FW_MAX_FC features and _FWS_MAX_K values, ties to the
    larger."""
    if ks - J <= _MAX_ORDER and ks - 1 <= _MAX_BASES:
        return fwd_plan(din, dout, J).fc
    fits = [fc for fc in range(1, min(din, _FW_MAX_FC) + 1)
            if fwd_ws_smem(tile, fc, J, ks) <= _SMEM_MAX
            and _round16(fc * J) <= _FWS_MAX_K]
    return min(fits, key=lambda fc: (_fws_cost(din, fc, J), -fc))


def fwd_plan(din: int, dout: int, J: int, mode: str = "bf16x3",
             ks: int = _KNOT_STRIDE, wide: bool = False) -> FwdPlan:
    """G's launch for one layer (knot rows of ``ks`` floats) in the default
    build of kan.cu, or with ``wide`` in the wide one.  tc: the column tile
    is the least power of two >= dout in 64..256; in the default build it
    is halved (not below 64) while one feature's chunk does not fit in
    shared memory (a large J), and the chunk (at most _FW_MAX_FC features:
    two (row, feature) pairs a thread) is the one of least ``_fc_cost``
    within shared memory, ties to the larger; the wide build keeps the
    tile and takes ``_fwd_ws_fc``'s chunk.  narrow: every output held, up
    to 32 features a chunk within shared memory.  fma: the column groups
    that cover dout (<= 32), or the nearest whose tile holds one feature's
    chunk, and the most features a chunk within _SMEM_BUDGET."""
    route = layer_route(dout, mode)
    if route == "tc" and wide:
        tile = _pow2_at_least(dout, 64, 256)
        return FwdPlan(route, tile, _fwd_ws_fc(din, dout, J, ks, tile),
                       _FW_TM)
    if route == "tc":
        tile = _pow2_at_least(dout, 64, 256)
        while tile > 64 and fwd_tc_smem(tile, 1, J, ks) > _SMEM_MAX:
            tile //= 2
        fits = [fc for fc in range(1, min(din, _FW_MAX_FC) + 1)
                if fwd_tc_smem(tile, fc, J, ks) <= _SMEM_MAX]
        fc = min(fits, key=lambda fc: (_fc_cost(din, fc, J), -fc))
        return FwdPlan(route, tile, fc, _FW_TM)
    if route == "narrow":
        no = _pow2_at_least(dout, 1, 8)
        fc = min(din, _NF_FC)
        while fc > 1 and fwd_narrow_smem(no, J, fc, ks) > _SMEM_MAX:
            fc -= 1
        return FwdPlan(route, no, fc, _THREADS)

    def smem(cg, fc):
        tm, tn, kcp = 1024 // cg, 8 * cg, _round4(fc * J)
        return 4 * (2 * tm * _ld(kcp) + 2 * kcp * tn + fc * ks)

    # the column groups nearest those that cover dout whose tile holds one
    # feature's chunk (fewer rows for a narrow layer, fewer columns for a
    # wide one, at a large J)
    want = _col_groups(dout, 32).bit_length()
    cg = min((c for c in (1, 2, 4, 8, 16, 32) if smem(c, 1) <= _SMEM_MAX),
             key=lambda c: (abs(c.bit_length() - want), c))
    fc = 1
    while fc < din and smem(cg, fc + 1) <= _SMEM_BUDGET:
        fc += 1
    return FwdPlan(route, cg, fc, 1024 // cg)


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """H's dW launch for one layer: its route ('tc': tensor cores, dout >=
    8; 'narrow': dout < 8; 'fma': the highest tier on CUDA cores), its
    column tile (tc: columns; narrow: outputs held, >= dout; fma: column
    groups of 8), input features per K tile (tc: the most a tile
    touches), rows per chunk, rows per slice, slices, and (tc) the K values
    a tile: fck whole features while J <= 64, else 64 values that may cut
    through features."""

    route: str
    tile: int
    fck: int
    rc: int
    rows_per_slice: int
    slices: int
    ktile: int = 0


def bwd_tc_smem(tn: int, fck: int, ks: int = _KNOT_STRIDE) -> int:
    """Dynamic shared memory of the tensor-core dW pass without dx (kan.cu
    bwd_tc_smem): A^T's planes, two stages of g's planes and the knots."""
    return (2 * _TC_TK * (_TC_RC + 8) * 2 + 2 * 2 * _TC_RC * (tn + 8) * 2
            + fck * ks * 4)


def bwd_ws_smem(tn: int, fck: int, ks: int = _KNOT_STRIDE) -> int:
    """Dynamic shared memory of the tensor-core backward with dx fused
    (kan.cu bwd_ws_smem): W's resident planes, _WS_STAGES stages of g's,
    _WS_BUFS buffers of A^T's planes and of the parked GX, their mbarriers,
    the knots, and each (row, feature) slot's previous interval."""
    return (2 * _TC_TK * (tn + 8) * 2 + _WS_STAGES * 2 * _TC_RC * (tn + 8) * 2
            + _WS_BUFS * 2 * _TC_TK * (_TC_RC + 8) * 2
            + _WS_BUFS * _TC_RC * (_TC_TK + 1) * 4 + 4 * _WS_BUFS * 8
            + fck * ks * 4 + _WS_BUFS * _TC_RC * fck * 2)


def narrow_bins_smem(no: int, J: int, fck: int,
                     ks: int = _KNOT_STRIDE) -> int:
    """Dynamic shared memory of the narrow H (kan.cu narrow_bins_smem):
    hi.hi and cross bins of ``no`` outputs x J values for each of the CTA's
    _NW_RG * fck threads (the column stride padded to a multiple of 32 from
    4 features up), the knot rows, and W^T's two planes of the CTA's
    features."""
    threads = _NW_RG * fck
    stride = -(-threads // 32) * 32 if fck >= 4 else threads
    return 4 * (no * J * 2 * stride + fck * ks + no * J * 2 * fck)


def dw_plan(n: int, din: int, dout: int, J: int, mode: str = "bf16x3",
            ks: int = _KNOT_STRIDE, wide: bool = False) -> DwPlan:
    """Enough slices of rows that the (K tile, column tile, slice) grid
    fills the card; the slice count depends on the shapes (and the tier's
    route) alone, so the summation order does not depend on the scratch
    budget.  A large J (the wide library) cuts the tensor-core K tiles
    through features and narrows the FMA column tile until its K tile
    holds a feature.  The narrow route's slices are those of a grid of 32
    features x blocks of _NW_JB values (they fix dW's sum order); its CTAs
    take as many features, up to 32, as its bins hold in shared memory, in
    both libraries (dW and dx do not depend on that count)."""
    route = layer_route(dout, mode)
    ktile = 0
    if route == "tc":
        tile = _pow2_at_least(dout, 32, 256)
        if J <= _TC_TK:
            fck = min(din, _TC_TK // J)
            ktile = fck * J
        else:
            ktile = _TC_TK
            fck = min(din, (ktile - 1) // J + 2)
        rc = _TC_RC
        tiles = -(-din * J // ktile) * -(-dout // tile)
    elif route == "narrow":
        tile = _pow2_at_least(dout, 1, 8)
        fck, rc = min(_NW_F, din), _NW_RG
        while fck > 1 and narrow_bins_smem(tile, J, fck, ks) > _SMEM_MAX:
            fck -= 1
        tiles = -(-din // _NW_F) * -(-J // _NW_JB)
    else:
        tile = _col_groups(dout, 16)
        while 1024 // tile < J:
            tile //= 2
        tmk, tn = 1024 // tile, 8 * tile
        fck = min(din, tmk // J)

        def smem(rc):
            return 4 * (2 * tmk * _ld(rc) + 2 * rc * tn + fck * ks)

        rc = 4
        while rc < 256 and smem(rc + 4) <= _SMEM_BUDGET:
            rc += 4
        tiles = -(-din // fck) * -(-dout // tn)
    slices = max(1, min(-(-_TARGET_CTAS // tiles), -(-n // rc)))
    rows = -(-(-(-n // slices)) // rc) * rc
    return DwPlan(route, tile, fck, rc, rows, -(-n // rows), ktile)


def dw_group(plan: DwPlan, dout: int, K: int) -> int:
    """Slices per dW launch: as many partial sums as ``SCRATCH_BYTES``
    holds, at least one."""
    return max(1, min(plan.slices, SCRATCH_BYTES // (4 * dout * K)))


def dx_fused(dout: int, mode: str, J: int = 1) -> bool:
    """Whether a layer's dx comes out of its dW pass (the tensor-core and
    narrow routes; the tensor-core one needs every output in one column
    tile, dout <= 256, and whole features in a K tile, J <= 64); else
    ``dx_plan``'s launch runs after it."""
    route = layer_route(dout, mode)
    return route == "narrow" or (route == "tc" and dout <= 256
                                 and J <= _TC_TK)


def bwd_pass(plan: DwPlan, fused: bool) -> str:
    """H's dW kernel for a layer on ``plan`` whose dx the pass forms or not
    (``fused``): 'ws' (kan_bwd_ws_kernel: the tensor-core pass with dx,
    builder warps beside the product warps) where the route is 'tc' and dx
    is fused, else the route's ('tc': kan_bwd_tc_kernel, dW alone;
    'narrow'; 'fma').  The shapes pick it: no flag does."""
    return "ws" if plan.route == "tc" and fused else plan.route


@dataclasses.dataclass(frozen=True)
class DxPlan:
    """H's dx launch for a layer whose dW pass does not form it: its route
    ('tc': kan_dx_tc_kernel on the tensor cores; 'fma': kan_dx_kernel),
    rows a CTA, input features a chunk, and ``inner``: the chunk's K values
    padded to the warps' n8 tiles (tc) or dout per inner chunk (fma)."""

    route: str
    tm: int
    fc: int
    inner: int


def _round32(v: int) -> int:
    return (v + 31) // 32 * 32


def dx_tc_smem(tm: int, dout: int, nc: int, fc: int,
               ks: int = _KNOT_STRIDE) -> int:
    """Dynamic shared memory of the tensor-core dx (kan.cu dx_tc_smem): g's
    resident bf16 planes (tm rows x dout rounded up to 32), _DX_STAGES
    stages of W's planes (nc K values x _DX_OC outputs), two buffers of
    parked GX and of knots."""
    return (2 * tm * (_round32(dout) + 8) * 2
            + _DX_STAGES * 2 * nc * (_DX_OC + 8) * 2 + 2 * tm * (nc + 4) * 4
            + 2 * fc * ks * 4)


def dx_plan(din: int, dout: int, J: int, mode: str = "bf16x3",
            ks: int = _KNOT_STRIDE) -> DxPlan:
    """H's dx launch for a layer whose dW pass does not form it (dout >
    256, or J > 64 in the wide library; the highest tier's every layer).
    The bf16 tiers take the tensor cores: 64-row tiles, or 32 where g's
    resident tile does not fit beside W's stages, with the chunk of whole
    features of least padded K values (plus _DX_CHUNK a chunk) within 128
    values and shared memory, ties to the larger.  Past what fits (dout
    672 at J = 127, 1504 at J = 9) and in the highest tier, the FMA
    kernel: (input features per chunk, dout per inner chunk)."""
    if mode in _TC_MODES:
        for tm in _DX_TC_TMS:
            step = 8 * (8 // (tm // 16))   # K values per n8 tile of all warps
            fits = []
            for fc in range(1, min(din, _DX_NC // J) + 1):
                nc = -(-fc * J // step) * step
                if nc <= _DX_NC and dx_tc_smem(tm, dout, nc, fc,
                                               ks) <= _SMEM_MAX:
                    fits.append((-(-din // fc) * (nc + _DX_CHUNK), -fc, nc))
            if fits:
                _, fc, nc = min(fits)
                return DxPlan("tc", tm, -fc, nc)
    fcx = min(din, _DX_TN // J)

    def smem(ic):
        return 4 * (2 * _DX_TM * _ld(ic) + 2 * ic * _DX_TN
                    + _DX_TM * _DX_TN + fcx * ks)

    ic = min(32, _round4(dout))
    while ic > 4 and smem(ic) > _SMEM_BUDGET:
        ic -= 4
    return DxPlan("fma", _DX_TM, fcx, ic)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU; the reference the kernels are held to)
# ---------------------------------------------------------------------------

def _sigmoid_ref(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def _features_plain(x: torch.Tensor, grid: torch.Tensor,
                    order: int) -> torch.Tensor:
    """A's rows: per feature [silu(x), B_0(x), ..., B_{n_coef-1}(x)] ->
    (n, din * J)."""
    silu = x * _sigmoid_ref(x)
    feats = torch.cat([silu.unsqueeze(-1), b_splines(x, grid, order)], -1)
    return feats.reshape(x.shape[0], -1)


def kan_layer_forward_plain(x: torch.Tensor, grid: torch.Tensor,
                            w_t: torch.Tensor, order: int,
                            mode: str) -> torch.Tensor:
    """One layer: A(x) @ W in the tier -> (n, dout)."""
    return _kernel_dot(_features_plain(x, grid, order), w_t.T, mode)


def kan_layer_backward_plain(x: torch.Tensor, grid: torch.Tensor,
                             w_t: torch.Tensor, g: torch.Tensor, order: int,
                             mode: str, need_dx: bool):
    """One layer's backward for the output cotangent g (n, dout) -> (dW^T
    (dout, K), dx (n, din) or None).  dx weights each of g @ W^T's J
    values per feature by silu'(x) or by the B-spline derivative, summed
    in coefficient order as the TPU kernel does."""
    n, din = x.shape
    a = _features_plain(x, grid, order)
    dw_t = _kernel_dot(a.T, g, mode).T
    if not need_dx:
        return dw_t, None
    J = w_t.shape[1] // din
    gx = _kernel_dot(g, w_t, mode).reshape(n, din, J)
    sig = _sigmoid_ref(x)
    v = gx[..., 0] * (sig * (1.0 + x * (1.0 - sig)))
    prev = b_splines(x, grid, order - 1)
    t = grid
    for c in range(J - 1):
        db = order * (prev[..., c] / (t[:, c + order] - t[:, c])
                      - prev[..., c + 1] / (t[:, c + order + 1]
                                            - t[:, c + 1]))
        v = v + gx[..., 1 + c] * db
    return dw_t, v


def kan_forward_plain(layers, coords: torch.Tensor, order: int, mode: str):
    """The stack: layers [(grid, W^T)], coords (n, d) -> (out, the input
    of every layer)."""
    x, xs = coords, [coords]
    for li, (grid, w_t) in enumerate(layers):
        x = kan_layer_forward_plain(x, grid, w_t, order, mode)
        if li < len(layers) - 1:
            xs.append(x)
    return x, xs


def kan_backward_plain(layers, xs, g: torch.Tensor, order: int,
                       mode: str) -> list[torch.Tensor]:
    """dW^T of every layer for the output cotangent g, from the layer
    inputs ``xs`` the forward kept."""
    grads: list[torch.Tensor] = [None] * len(layers)
    for li in range(len(layers) - 1, -1, -1):
        grid, w_t = layers[li]
        grads[li], g = kan_layer_backward_plain(xs[li], grid, w_t, g, order,
                                                mode, need_dx=li > 0)
    return grads


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/kan.cu)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


class _KanLibrary:
    """``csrc/kan.cu`` built once per process (at first use) under
    ``name`` with the extra nvcc ``defines``."""

    def __init__(self, name: str = "kan", defines: tuple[str, ...] = ()):
        self.name, self.defines = name, defines
        self._lib = None

    def __call__(self):
        if self._lib is None:
            lib = build_library(self.name, ["kan.cu"], self.defines)
            lib.kan_split.argtypes = [_P] * 7 + [_I] * 4 + [_P]
            lib.kan_gsplit.argtypes = [_P] * 3 + [ctypes.c_longlong, _I, _I,
                                                  _P]
            lib.kan_forward.argtypes = [_P] * 5 + [_I] * 8 + [_P]
            lib.kan_forward_tc.argtypes = ([_P] * 4 + [_I, _P] + [_I] * 8
                                           + [_P])
            lib.kan_forward_narrow.argtypes = [_P] * 5 + [_I] * 8 + [_P]
            lib.kan_dw.argtypes = [_P] * 4 + [_I] * 12 + [_P]
            lib.kan_bwd_tc.argtypes = ([_P] * 6 + [_I] + [_P] * 2
                                       + [_I] * 12 + [_P])
            lib.kan_bwd_narrow.argtypes = [_P] * 7 + [_I] * 11 + [_P]
            lib.kan_reduce.argtypes = [_P, _P, ctypes.c_longlong, _I, _I, _P]
            lib.kan_dx.argtypes = [_P] * 6 + [_I] * 8 + [_P]
            lib.kan_dx_tc.argtypes = [_P] * 6 + [_I, _P] + [_I] * 9 + [_P]
            for fn in (lib.kan_split, lib.kan_gsplit, lib.kan_forward,
                       lib.kan_forward_tc, lib.kan_forward_narrow,
                       lib.kan_dw, lib.kan_bwd_tc, lib.kan_bwd_narrow,
                       lib.kan_reduce, lib.kan_dx, lib.kan_dx_tc):
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib


KAN_LIBRARY = _KanLibrary()
KAN_WIDE_LIBRARY = _KanLibrary("kan_wide", ("-DKAN_WIDE=1",))


def kan_library(order: int, n_knots: int) -> _KanLibrary:
    """The build of ``csrc/kan.cu`` that takes the config: the default one
    for orders up to 4 with at most 16 degree-0 bases, the wide one
    otherwise.  The wide build takes the default one's configs too, with
    the same outputs and gradients: by another kernel in G (builder and mma
    warps; chip_smoke.py phase 29 times both builds at the runner's grid 5
    / order 3), by the same kernels in H.  The narrow H (dout < 8) is one
    kernel in both builds: each (row, feature)'s bases once, only the
    values that can be non-zero added into per-thread bins, each bin's FMA
    chains in row order; the values it skips are exact zeros, whose
    products leave those chains' sums as they are, so its dW and dx are
    bit-equal to chains over every value."""
    return KAN_WIDE_LIBRARY if is_wide(order, n_knots) else KAN_LIBRARY


def _check_cuda(name: str, dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} is on {dev}; the KAN kernels take CUDA "
                         "tensors")


@dataclasses.dataclass(frozen=True)
class LayerShape:
    n: int
    din: int
    dout: int
    nk: int
    J: int

    @property
    def K(self) -> int:
        return self.din * self.J

    @property
    def ks(self) -> int:
        """The knot row's floats (the order is nk - J)."""
        return knot_stride(self.nk - self.J, self.nk)

    @property
    def wide(self) -> bool:
        """Whether the wide library takes the layer."""
        return is_wide(self.nk - self.J, self.nk)


def check_kernel_config(order: int, n_knots: int) -> None:
    """The kernels take spline orders 1..8 and up to 128 knots a feature
    (grid_size + 2 * spline_order <= 127, grid_size >= 1); anything else
    raises."""
    if (not 1 <= order <= _WIDE_MAX_ORDER
            or not order < n_knots - 1 < _WIDE_MAX_KNOTS):
        raise ValueError(
            f"the KAN kernels take spline_order 1..{_WIDE_MAX_ORDER} and "
            f"grid_size + 2 * spline_order <= {_WIDE_MAX_KNOTS - 1} (at "
            f"most {_WIDE_MAX_KNOTS} knots a feature); got order {order} "
            f"with {n_knots} knots")


def _layer_shape(x: torch.Tensor, grid: torch.Tensor, w_t: torch.Tensor,
                 order: int, li: int) -> LayerShape:
    dev = x.device
    n, din = x.shape
    nk = grid.shape[-1]
    check_kernel_config(order, nk)
    J = nk - order
    dout = w_t.shape[0]
    _check_tensor(f"layers[{li}] input", x, dev, (n, din))
    _check_tensor(f"layers[{li}].grid", grid, dev, (din, nk))
    _check_tensor(f"layers[{li}] W^T", w_t, dev, (dout, din * J))
    if n < 1:
        raise ValueError("kernel takes at least one row")
    return LayerShape(n, din, dout, nk, J)


def _split(lib, w_t, s: LayerShape, code: int, stream, *, rows: bool):
    """W's f32 hi/lo planes: (K, dout) for G's narrow and FMA kernels when
    ``rows``, else (dout, K) for H's FMA and narrow dx."""
    f32 = dict(dtype=torch.float32, device=w_t.device)
    shape = (s.K, s.dout) if rows else (s.dout, s.K)
    hi, lo = torch.empty(shape, **f32), torch.empty(shape, **f32)
    ptrs = (hi.data_ptr(), lo.data_ptr(), 0, 0) if rows else \
        (0, 0, hi.data_ptr(), lo.data_ptr())
    _check_rc("kan_split", lib.kan_split(w_t.data_ptr(), *ptrs, 0, 0, 0,
                                         s.dout, s.K, code, stream))
    return hi, lo


def split_w_bf16(lib, w_t, s: LayerShape, ldw: int, code: int, stream):
    """W's bf16 hi/lo planes (K, ldw) for the tensor-core G and dx: dout
    padded to whole column tiles, zero past dout."""
    bf = dict(dtype=torch.bfloat16, device=w_t.device)
    hi, lo = torch.zeros((s.K, ldw), **bf), torch.zeros((s.K, ldw), **bf)
    _check_rc("kan_split", lib.kan_split(w_t.data_ptr(), 0, 0, 0, 0,
                                         hi.data_ptr(), lo.data_ptr(), ldw,
                                         s.dout, s.K, code, stream))
    return hi, lo


def split_g(lib, g, s: LayerShape, plan: DwPlan, stream):
    """The cotangent's bf16 hi/lo planes (n, ldg), ldg = dout padded to
    whole tensor-core column tiles (zero past dout): the w role of the
    tensor-core dW and the x role of the tensor-core dx."""
    ldg = -(-s.dout // plan.tile) * plan.tile
    bf = dict(dtype=torch.bfloat16, device=g.device)
    hi, lo = torch.empty((s.n, ldg), **bf), torch.empty((s.n, ldg), **bf)
    _check_rc("kan_gsplit", lib.kan_gsplit(g.data_ptr(), hi.data_ptr(),
                                           lo.data_ptr(), s.n, s.dout, ldg,
                                           stream))
    return hi, lo


def layer_forward(lib, x, grid, w_t, s: LayerShape, order: int, mode: str,
                  stream) -> torch.Tensor:
    """One layer of G: y (n, dout) on the route of ``fwd_plan``, with W's
    planes made here: bf16 (K, whole column tiles) for the tensor cores,
    f32 (K, dout) for the narrow and FMA kernels."""
    plan = fwd_plan(s.din, s.dout, s.J, mode, s.ks, s.wide)
    code = _MODE_CODE[mode]
    y = torch.empty((s.n, s.dout), dtype=torch.float32, device=x.device)
    dims = (s.n, s.din, s.dout, s.nk, order, code)
    if plan.route == "tc":
        ldw = -(-s.dout // plan.tile) * plan.tile
        whi, wlo = split_w_bf16(lib, w_t, s, ldw, code, stream)
        _check_rc("kan_forward_tc", lib.kan_forward_tc(
            x.data_ptr(), grid.data_ptr(), whi.data_ptr(), wlo.data_ptr(),
            ldw, y.data_ptr(), *dims, plan.tile, plan.fc, stream))
        return y
    whi, wlo = _split(lib, w_t, s, code, stream, rows=True)
    if plan.route == "narrow":
        _check_rc("kan_forward_narrow", lib.kan_forward_narrow(
            x.data_ptr(), grid.data_ptr(), whi.data_ptr(), wlo.data_ptr(),
            y.data_ptr(), *dims, plan.tile, plan.fc, stream))
    else:
        _check_rc("kan_forward", lib.kan_forward(
            x.data_ptr(), grid.data_ptr(), whi.data_ptr(), wlo.data_ptr(),
            y.data_ptr(), *dims, plan.tile, plan.fc, stream))
    return y


class _KanFwdKernel(LaunchCounter):
    """Kernel G: the stack forward, one launch per layer (plus W's split):
    on tensor cores (dout >= 8) or as weighted sums per row (dout < 8) in
    the bf16 tiers, CUDA-core FMAs in the highest.
    ``launches`` rises by one per stack forward launched, nowhere else."""

    def __call__(self, layers, coords: torch.Tensor, order: int, mode: str):
        """layers [(grid, W^T)] and coords (n, d) on one CUDA device ->
        (out (n, dout), the input of every layer)."""
        dev = coords.device
        _check_cuda("coords", dev)
        x, xs = coords, [coords]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            for li, (grid, w_t) in enumerate(layers):
                s = _layer_shape(x, grid, w_t, order, li)
                lib = kan_library(order, s.nk)()
                x = layer_forward(lib, x, grid, w_t, s, order, mode, stream)
                if li < len(layers) - 1:
                    xs.append(x)
        self.count()
        return x, xs


def layer_backward(lib, x, grid, g, w_t, s: LayerShape, order: int,
                   mode: str, stream, need_dx: bool):
    """One layer of H for the output cotangent ``g``: (dW^T (dout, K), dx
    (n, din) or None).  dW goes over slices of rows in groups of
    ``dw_group``, each group's partial sums folded into the result in slice
    order; on the tensor-core and narrow routes the same launches write dx
    (``dx_fused``), else ``dx_plan``'s kernel runs after them (the
    tensor-core dx on the same planes, or the FMA one).  The planes (the
    cotangent's and W's bf16 splits for the tensor cores, W^T's f32 split
    otherwise) are made here, once per layer.  Each dW launch counts one
    on ``kan_bwd.launches.<bwd_pass>``."""
    plan = dw_plan(s.n, s.din, s.dout, s.J, mode, s.ks, s.wide)
    code = _MODE_CODE[mode]
    fused = need_dx and dx_fused(s.dout, mode, s.J)
    launches = counter(f"kan_bwd.launches.{bwd_pass(plan, fused)}")
    xplan = (dx_plan(s.din, s.dout, s.J, mode, s.ks)
             if need_dx and not fused else None)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((s.n, s.din), **f32) if need_dx else None
    if plan.route == "tc":
        ghi, glo = split_g(lib, g, s, plan, stream)
        whi, wlo = (split_w_bf16(lib, w_t, s, ghi.shape[1], code, stream)
                    if fused or (xplan and xplan.route == "tc")
                    else (None, None))
    elif need_dx:
        thi, tlo = _split(lib, w_t, s, code, stream, rows=False)
    group = dw_group(plan, s.dout, s.K)
    partial = torch.empty((group, s.dout, s.K), **f32)
    dw_t = torch.empty((s.dout, s.K), **f32)
    dims = (s.n, s.din, s.dout, s.nk, order, code)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    for s0 in range(0, plan.slices, group):
        sg = min(group, plan.slices - s0)
        rows = (plan.rows_per_slice, s0, sg, stream)
        out = ptr(dx) if fused else 0
        if plan.route == "tc":
            _check_rc("kan_bwd_tc", lib.kan_bwd_tc(
                x.data_ptr(), grid.data_ptr(), ghi.data_ptr(),
                glo.data_ptr(), ptr(whi), ptr(wlo), ghi.shape[1],
                partial.data_ptr(), out, *dims, plan.tile, plan.fck,
                plan.ktile, *rows))
        elif plan.route == "narrow":
            _check_rc("kan_bwd_narrow", lib.kan_bwd_narrow(
                x.data_ptr(), grid.data_ptr(), g.data_ptr(),
                ptr(thi) if fused else 0, ptr(tlo) if fused else 0,
                partial.data_ptr(), out, *dims, plan.tile, plan.fck,
                *rows))
        else:
            _check_rc("kan_dw", lib.kan_dw(
                x.data_ptr(), grid.data_ptr(), g.data_ptr(),
                partial.data_ptr(), *dims, plan.tile, plan.fck, plan.rc,
                *rows))
        launches.add()
        _check_rc("kan_reduce", lib.kan_reduce(
            partial.data_ptr(), dw_t.data_ptr(), s.dout * s.K, sg,
            int(s0 == 0), stream))
    if xplan and xplan.route == "tc":
        _check_rc("kan_dx_tc", lib.kan_dx_tc(
            x.data_ptr(), grid.data_ptr(), ghi.data_ptr(), glo.data_ptr(),
            whi.data_ptr(), wlo.data_ptr(), ghi.shape[1], dx.data_ptr(),
            *dims, xplan.tm, xplan.fc, xplan.inner, stream))
    elif xplan:
        if plan.route == "tc":
            thi, tlo = _split(lib, w_t, s, code, stream, rows=False)
        _check_rc("kan_dx", lib.kan_dx(
            x.data_ptr(), grid.data_ptr(), g.data_ptr(), thi.data_ptr(),
            tlo.data_ptr(), dx.data_ptr(), *dims, xplan.fc, xplan.inner,
            stream))
    return dw_t, dx


class _KanBwdKernel(LaunchCounter):
    """Kernel H: the stack backward for a supplied output cotangent, per
    layer in reverse: dW (product over rows + fixed-order reduce) and, for
    layers > 0, dx, one pass for both in the bf16 tiers: on tensor cores
    (dout >= 8: builder warps beside product warps, ``bwd_pass`` 'ws';
    past 256 outputs or J = 64, dx on the tensor cores after the dW pass)
    or as weighted sums (dout < 8); CUDA-core FMAs in the highest tier.
    ``launches`` rises by one per stack backward."""

    def __call__(self, layers, xs, g: torch.Tensor, order: int,
                 mode: str) -> list[torch.Tensor]:
        dev = g.device
        _check_cuda("cotangent", dev)
        grads: list[torch.Tensor] = [None] * len(layers)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            for li in range(len(layers) - 1, -1, -1):
                grid, w_t = layers[li]
                x = xs[li]
                s = _layer_shape(x, grid, w_t, order, li)
                lib = kan_library(order, s.nk)()
                _check_tensor("cotangent", g, dev, (s.n, s.dout))
                grads[li], g = layer_backward(lib, x, grid, g, w_t, s, order,
                                              mode, stream, need_dx=li > 0)
        self.count()
        return grads


KAN_FWD = _KanFwdKernel("kan_fwd")
KAN_BWD = _KanBwdKernel("kan_bwd")


def kan_stack_forward(layers, coords: torch.Tensor, order: int, mode: str):
    """G for CUDA tensors, its plain version for CPU ones."""
    if coords.device.type == "cpu":
        return kan_forward_plain(layers, coords, order, mode)
    if coords.device.type != "cuda":
        raise ValueError(f"no fused KAN for device {coords.device}")
    return KAN_FWD(layers, coords, order, mode)


def kan_stack_backward(layers, xs, g: torch.Tensor, order: int,
                       mode: str) -> list[torch.Tensor]:
    """H for CUDA tensors, its plain version for CPU ones."""
    if g.device.type == "cpu":
        return kan_backward_plain(layers, xs, g, order, mode)
    if g.device.type != "cuda":
        raise ValueError(f"no fused KAN backward for device {g.device}")
    return KAN_BWD(layers, xs, g, order, mode)


# ---------------------------------------------------------------------------
# The differentiable stack
# ---------------------------------------------------------------------------

class _FusedKAN(torch.autograd.Function):
    """Forward: ``stack[0]``; backward: ``stack[1]`` (G and H through the
    dispatchers).  Inputs after coords are (grid, W^T) per layer; the grids
    get zero gradients."""

    @staticmethod
    def forward(ctx, order, mode, stack, coords, *flat):
        layers = list(zip(flat[0::2], flat[1::2]))
        out, xs = stack[0](layers, coords, order, mode)
        ctx.order, ctx.mode, ctx.stack = order, mode, stack
        ctx.n_layers = len(layers)
        ctx.save_for_backward(*xs, *flat)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        xs, flat = saved[:ctx.n_layers], saved[ctx.n_layers:]
        layers = list(zip(flat[0::2], flat[1::2]))
        dws = ctx.stack[1](layers, list(xs), grad_out.contiguous(),
                           ctx.order, ctx.mode)
        grads = []
        for (grid, _), dw in zip(layers, dws):
            grads += [torch.zeros_like(grid), dw]
        grads = [gr if need else None
                 for gr, need in zip(grads, ctx.needs_input_grad[4:])]
        return (None, None, None, None, *grads)


def flatten_kan_params(params: Params) -> list[torch.Tensor]:
    """[grid, W^T] per layer: W^T = cat([base_w[..., None], spline_w *
    spline_scaler[..., None]], -1) as (out, in * J), differentiable."""
    flat = []
    for p in params["layers"]:
        sw = _scaled_spline_weight(p)
        w_t = torch.cat([p["base_w"].unsqueeze(-1), sw], dim=-1)
        flat += [p["grid"].contiguous(), w_t.reshape(sw.shape[0], -1)]
    return flat


STACK = (kan_stack_forward, kan_stack_backward)
PLAIN_STACK = (kan_forward_plain, kan_backward_plain)


def fused_kan_apply(params: Params, cfg: KANConfig, coords: torch.Tensor,
                    stack=STACK) -> torch.Tensor:
    """Drop-in for ``kan_apply`` under autograd: (n, d) coords -> (n, out),
    G forward and H backward on a card.  Any n is taken as it is.
    ``stack`` is the (forward, backward) pair; a comparison on the card
    passes ``PLAIN_STACK`` to run the plain versions there."""
    for li, layer in enumerate(params["layers"]):
        for key, v in layer.items():
            if v.device != coords.device:
                raise ValueError(f"layers[{li}].{key} is on {v.device}, "
                                 f"coords on {coords.device}")
    return _FusedKAN.apply(cfg.spline_order, kan_dot_mode(), stack,
                           coords.to(torch.float32).contiguous(),
                           *flatten_kan_params(params))
