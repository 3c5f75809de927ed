"""What one call of a step costs, counted op by op as it runs: the
counterpart of the JAX package's launch/hlo_cost.py, which reads the
compiled HLO of a cell.

StepCost is a TorchDispatchMode.  Over one call of a step it counts:
  * dot FLOPs: every op that torch.utils.flop_counter has a formula for
    (mm, bmm, addmm, baddbmm, convolutions, SDPA), as FlopCounterMode
    counts them, plus each hand-written kernel's FLOPs from its formula
    below;
  * a memory-traffic proxy: the bytes of every materialised op result
    (views, in-place and out= results and empty allocations excluded),
    plus each kernel's bytes from its formula (its inputs read once, its
    outputs written once), as hlo_cost.py sums materialised result
    buffers;
  * transcendental elements: the result elements of exp, log, tanh,
    sigmoid, rsqrt and their kin, plus each kernel's exponentials;
  * collectives by kind (all_gather, all_reduce, reduce_scatter,
    all_to_all, broadcast): calls and payload bytes (a gather's gathered
    output, a reduction's tensor), read off the c10d ops the dispatcher
    sees - every torch.distributed collective the step makes;
  * kernels by name (K1-K7, and K6_bwd / K7_bwd, the scans'
    backward kernels): calls, FLOPs and bytes;
  * the peak of live result bytes: each result counts from the op that
    makes it until its tensor object is freed (a view that outlives its
    base is not counted past it, so this is a lower bound of the peak).
Eager PyTorch runs every iteration of every loop (the layers, the
sequence-parallel decode's blocks), so each op is counted as often as it
runs: this module needs no counterpart of hlo_cost.py's _trip_count,
which recovers the trip counts of XLA while loops that cost_analysis
counts once.

The hand-written kernels are bound through ctypes (kernels/build.py), so
the dispatcher never sees them: each kernel wrapper, given tensors on the
meta device, returns empty meta outputs of the right shape and dtype and
reports its kernel's formula here (record_kernel).  The formulas (k1_work
.. k7_work, k6_bwd_work, k7_bwd_work) are also what chip_smoke.py's
bound_ms column divides by the card's rates, so the dry run and the bound
count the same work whatever implements the kernel.  Where the work depends on the data (the lengths
of K1-K3), the caller passes what the data needs; the meta path, which
has no data, passes the whole cache or block table, as XLA's cost of a
masked computation counts it whole.
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ---------------------------------------------------------------------------
# the kernels' work: (bytes moved, FLOPs) of one call
# ---------------------------------------------------------------------------


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, attended key) pairs of one head under the mask: query s sees
    keys [s - window + 1, s] under a window, [0, s] causal, every key
    otherwise (top-left aligned, as K4 and K5)."""
    s = np.arange(sq, dtype=np.int64)
    masked = causal or window > 0
    hi = np.minimum(s + 1, skv) if masked else np.full(sq, skv)
    lo = np.maximum(0, s - window + 1) if window > 0 else 0
    return int(np.maximum(hi - lo, 0).sum())


def chunk_rows_work(rows: Sequence[Tuple[int, int]], window: int
                    ) -> Tuple[int, int]:
    """(pairs, K/V positions read) of K1's rows [(q_offset, true_len)]:
    each live query s of a row attends keys up to its own position within
    the row's cursor, the K/V positions from the row's first query's window
    to its cursor are read once."""
    lo = lambda p: max(p - window + 1, 0) if window > 0 else 0
    pairs, kv_pos = 0, 0
    for off, tl in rows:
        n = max(tl - off, 0)
        if not n:
            continue
        s = np.arange(off, off + n, dtype=np.int64)
        his = np.minimum(s + 1, tl)
        los = np.maximum(s - window + 1, 0) if window > 0 else 0
        pairs += int((his - los).sum())
        kv_pos += tl - lo(off)
    return pairs, kv_pos


def k1_work(q_shape, kv_heads: int, itemsize: int, pairs: int,
            kv_pos: int) -> Tuple[int, int]:
    """K1: q and the output once, each row's K/V positions once; 4 D Hq
    FLOPs per (live query, attended key) pair."""
    K, S, Hq, D = q_shape
    nbytes = 2 * _numel(q_shape) * itemsize \
        + 2 * kv_pos * kv_heads * D * itemsize
    return nbytes, 4 * D * Hq * pairs


def decode_work(q_shape, kv_heads: int, itemsize: int,
                positions: int) -> Tuple[int, int]:
    """K2 and K3: q and the output once, each lane's visible K/V positions
    once; 4 D Hq FLOPs per position."""
    B, _, Hq, D = q_shape
    return (2 * _numel(q_shape) * itemsize
            + 2 * positions * kv_heads * D * itemsize,
            4 * D * Hq * positions)


def decode_positions(lens, S: int, window: int) -> int:
    """The K/V positions a batch of decode lanes of lengths `lens` sees in
    strips of S positions (K3: a lane past its strip sees the strip)."""
    return int(sum(min(int(n), S) - (max(0, int(n) - window) if window > 0
                                     else 0) for n in lens))


def k4_work(q_shape, k_shape, itemsize: int, causal: bool,
            window: int) -> Tuple[int, int]:
    """K4: q, K and V read once, o and the fp32 lse written once; 4 D Hq
    FLOPs per (query, attended key) pair under the mask."""
    B, Sq, Hq, D = q_shape
    pairs = attention_pairs(Sq, k_shape[1], causal, window)
    nbytes = (2 * _numel(q_shape) + 2 * _numel(k_shape)) * itemsize \
        + 4 * B * Sq * Hq
    return nbytes, 4 * D * Hq * B * pairs


def k5_work(q_shape, k_shape, itemsize: int, causal: bool,
            window: int) -> Tuple[int, int]:
    """K5: q, k, v, o, do and the fp32 lse read once, dq, dk, dv written
    once; five products of 2 D FLOPs (s = q k, dp = do v, dv += p do, dq
    += ds k, dk += ds q) per (query head, attended key) pair."""
    B, Sq, Hq, D = q_shape
    pairs = attention_pairs(Sq, k_shape[1], causal, window)
    nbytes = (4 * _numel(q_shape) + 4 * _numel(k_shape)) * itemsize \
        + 4 * B * Sq * Hq
    return nbytes, 10 * D * Hq * B * pairs


def k6_work(x_shape, N: int, itemsize: int, chunk: int = 128
            ) -> Tuple[int, int]:
    """K6: x, dt, A, B, C read once, y written once; the chunked form's
    products over `chunk`-step chunks, the causal half of each chunk's
    pairs (C B^T masked, times dt x), the carry-in C h and the state update
    (dt x)^T B: 2 (T (T + 1) / 2 (N + P) + 2 T N P) FLOPs per chunk, head
    and sequence."""
    B, S, H, P = x_shape
    nbytes = 2 * _numel(x_shape) * itemsize + 2 * B * S * N * itemsize \
        + (B * S * H + H) * 4
    flops = 0
    for c0 in range(0, S, chunk):
        t = min(chunk, S - c0)
        flops += 2 * (t * (t + 1) // 2 * (N + P) + 2 * t * N * P)
    return nbytes, flops * B * H


def k7_work(r_shape, V: int, itemsize: int, chunk: int = 32
            ) -> Tuple[int, int]:
    """K7: r, k, v, w, u read once, y written once; the chunked form's
    products over `chunk`-step chunks: the strictly lower pairs (r e^cw)
    (k e^-cw)^T times v, the diagonal (r u k) v, the carry-in r S and the
    state update k^T v: T (T - 1) (K + V) + 3 T K + 4 T K V FLOPs per
    chunk, head and sequence."""
    B, S, H, K = r_shape
    nbytes = (2 * _numel(r_shape) + 2 * B * S * H * V) * itemsize \
        + (B * S * H * K + H * K) * 4
    flops = 0
    for c0 in range(0, S, chunk):
        t = min(chunk, S - c0)
        flops += t * (t - 1) * (K + V) + 3 * t * K + 4 * t * K * V
    return nbytes, flops * B * H



def k6_bwd_work(x_shape, N: int, itemsize: int) -> Tuple[int, int]:
    """K6's backward (csrc/mamba2_scan_bwd.cu): x, dt, A, B, C and dy read
    once, dx, ddt, dA, dB and dC written once; the recurrence's work per
    state element and step - the state recomputed twice (the saved states'
    pass and once more inside each stretch between them), the adjoint g =
    C dy + a g', the terms of dx, dB and dC, and <h_{t-1}, g> for ddt and
    dA - 2 FLOPs each: 14 P N FLOPs per (sequence, step, head)."""
    B, S, H, P = x_shape
    nbytes = 3 * _numel(x_shape) * itemsize + 4 * B * S * N * itemsize \
        + 2 * (B * S * H + H) * 4
    return nbytes, 14 * B * S * H * P * N


def k7_bwd_work(r_shape, V: int, itemsize: int) -> Tuple[int, int]:
    """K7's backward (csrc/rwkv6_scan_bwd.cu): r, k, v, w, u and dy read
    once, dr, dk, dv, dw and du written once; the recurrence's work per
    state element and step - the state recomputed twice, the terms of dr
    (S dy), dk (G v), dv (G k and the bonus), dw (S . G) and the adjoint
    G' = w G + r dy - 16 K V FLOPs per (sequence, step, head)."""
    B, S, H, K = r_shape
    nbytes = (4 * _numel(r_shape) + 3 * B * S * H * V) * itemsize \
        + 2 * (B * S * H * K + H * K) * 4
    return nbytes, 16 * B * S * H * K * V

# ---------------------------------------------------------------------------
# the counting mode
# ---------------------------------------------------------------------------

_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log2", "log1p", "tanh",
                   "sigmoid", "rsqrt", "sqrt", "sin", "cos", "erf", "gelu",
                   "silu", "softplus", "_softmax", "_log_softmax"}
# c10d op name -> collective kind, and which argument's tensors are the
# payload (0: the first argument; the gather's output)
_COLLECTIVES = {"_allgather_base_": "all_gather", "allgather_": "all_gather",
                "allgather_into_tensor_coalesced_": "all_gather",
                "allreduce_": "all_reduce",
                "allreduce_coalesced_": "all_reduce",
                "reduce_scatter_tensor_coalesced_": "reduce_scatter",
                "_reduce_scatter_base_": "reduce_scatter",
                "reduce_scatter_": "reduce_scatter",
                "alltoall_base_": "all_to_all", "alltoall_": "all_to_all",
                "broadcast_": "broadcast"}
_FACTORIES = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided"}

_ACTIVE: List["StepCost"] = []


def _tensors(x) -> List[torch.Tensor]:
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def record_kernel(name: str, nbytes: int, flops: int,
                  transcendentals: int = 0) -> None:
    """A kernel wrapper's meta call: `name`'s formula into every active
    StepCost (nothing when none is active)."""
    for mode in _ACTIVE:
        mode.kernel(name, nbytes, flops, transcendentals)


class StepCost(TorchDispatchMode):
    """Counts what runs under it (the module docstring); read the totals
    with summary() after the `with` block."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.collectives: Dict[str, Dict[str, int]] = {}
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.live = 0
        self.peak = 0

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def kernel(self, name: str, nbytes: int, flops: int,
               transcendentals: int) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)
        self.flops += int(flops)
        self.bytes += int(nbytes)
        self.transcendentals += int(transcendentals)

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.namespace == "c10d":
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                c = self.collectives.setdefault(kind, {"calls": 0,
                                                       "bytes": 0})
                c["calls"] += 1
                c["bytes"] += sum(_nbytes(t) for t in _tensors(args[0]))
            return out
        if func.overloadpacket in self._flops_of:
            # an out_dtype overload (bmm.dtype) has the formula's tensors
            # ahead of its dtype
            dt = [i for i, a in enumerate(args) if isinstance(a, torch.dtype)]
            self.flops += int(self._flops_of[func.overloadpacket](
                *args[:dt[0] if dt else len(args)], **kwargs, out_val=out))
        results = [t for t, r in zip(_tensors(out), func._schema.returns)
                   if r.alias_info is None] \
            if len(func._schema.returns) == len(_tensors(out)) else []
        if name.rstrip("_") in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in _tensors(out))
        for t in results:
            self._track(t)
            if name not in _FACTORIES:
                self.bytes += _nbytes(t)
        return out

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes_accessed": self.bytes,
                "transcendentals": self.transcendentals,
                "peak_live_bytes": self.peak,
                "collectives": {k: dict(v) for k, v in
                                sorted(self.collectives.items())},
                "kernels": {k: dict(v) for k, v in
                            sorted(self.kernels.items())}}

