"""Mixture-of-experts routing and the expert FFN — the counterpart of
``accelerate_tpu/ops/moe.py``, with its three dispatch back-ends:

- **sorted**: claims (token, choice) grouped by expert id by a counting
  sort, the expert FFNs run as a grouped matmul over each expert's
  contiguous rows (JAX's ``lax.ragged_dot``, an XLA op: here one
  ``torch.matmul`` per expert). O(B·S·k) routing memory. The group sizes
  are read on the host to slice the rows: **one device-to-host read of E
  integers a layer**, which waits for the routing of that layer to finish
  (its cost on the card is in PERF.md, phase 20 F);
- **einsum**: dense one-hot dispatch and combine tensors ``(B, S, E, C)``
  and batched einsums over a leading expert dim (GShard). The form the
  ep axis shards;
- **indexed**: a slot-to-token index map scattered from the claim ranks,
  tokens gathered into ``(E, B, C, h)`` capacity slots, the same dense
  expert einsums, and the combine a gather.

All three share one routing front-end (:func:`_route`): softmax over the
experts in f32, top-k with ties to the lower expert index (a stable
descending sort; ``torch.topk`` promises no order for ties), gates
renormalised over the k choices, and per batch row each claim ranked over
the flattened (S·k) axis, token-major then choice, earlier claims taking an
expert's ``capacity`` slots first (later ones are dropped: gate 0, the
token rides the residual stream). The Switch load-balancing loss is
``E · Σ_e f_e · p̄_e`` (top-1 token fraction times mean router
probability; 1 at perfect balance).

:func:`moe_ffn` picks the back-end as the JAX package does: ep > 1 →
einsum; else einsum when S ≤ 2048 and ``capacity_factor`` ≤ 2, else sorted;
``ACCELERATE_MOE_DISPATCH=sorted|einsum|indexed`` overrides, and any other
value raises. The three are plain PyTorch implementations of one function;
none of them is a kernel (the JAX package has no Pallas kernel here).

**Expert parallelism.** The expert weights may come as lists of pieces,
one per rank of the expert group this process holds (``group``, a
``parallel/tensor`` context over the ep ranks, the tp ranks, or both; a
piece holds ``E / ep`` experts, and under tp the columns of ``w_gate`` and
``w_up`` and the rows of ``w_down`` of its tp rank). The routing runs
replicated on every rank; each rank computes the FFN of its own experts
only and the ranks' partial outputs are summed by ``group.reduce``. The
input and the gates reach a rank's experts through ``group.copy``, so in
the backward their gradients sum over the ranks (a gate's gradient for an
expert exists only on the rank that owns it) while the router loss's
gradient, whole on every rank, is counted once.

**The router loss over data ranks.** ``stats`` (None: the batch is whole)
makes ``f`` the top-1 fraction over the global batch when the rows are
split over data ranks: ``stats(f, key)`` returns it (``key`` names the
layer and microbatch), and ``stats.share`` scales the layer's loss (1 when
each rank's loss is the mean of its own rows, ``1 / n`` when it is its
share of the global mean). ``f`` has no gradient, so the ranks' losses sum
(or average) to the global batch's loss and gradient exactly.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
import torch.nn.functional as F

DISPATCH_ENV = "ACCELERATE_MOE_DISPATCH"


def router_capacity(tokens_per_group: int, num_experts: int, k: int,
                    capacity_factor: float) -> int:
    """Slots per expert per batch row, rounded up to a multiple of 8."""
    cap = int(math.ceil(tokens_per_group * k * capacity_factor / num_experts))
    return max(8, int(math.ceil(cap / 8)) * 8)


class DataRouterStats:
    """The top-1 fraction summed over the data ranks of a process group
    (``group``, ``n`` ranks), outside autograd; ``share`` as in the module
    docstring."""

    def __init__(self, group, n: int, share: float):
        self.group, self.n, self.share = group, int(n), float(share)

    def __call__(self, f, key):
        f = f.detach().clone()
        dist.all_reduce(f, op=dist.ReduceOp.SUM, group=self.group)
        return f / self.n


class RecordedRouterStats:
    """The top-1 fraction over data ranks that run one after another in
    this process (a loopback): a first forward of every rank records each
    rank's fraction by ``key`` (:attr:`replay` False), and the forward that
    trains reads their mean (:attr:`replay` True)."""

    def __init__(self, share: float):
        self.share = float(share)
        self.replay = False
        self.recorded = {}

    def __call__(self, f, key):
        if not self.replay:
            self.recorded.setdefault(key, []).append(f.detach())
            return f.detach()
        parts = self.recorded[key]
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total / len(parts)


def _top_k(probs, k: int):
    """``(values, indices)`` of the k largest along the last dim, ties to
    the lower index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router_logits, k: int, capacity: int, stats=None, key=None):
    """The shared routing front-end (module docstring). Returns a dict:
    ``expert_idx`` (B,S,k), ``gate_vals`` (B,S,k) renormalised, ``onehot``
    (B,S,k,E), ``pos`` (B,S·k,E) each claim's rank within its expert,
    ``keep`` (B,S·k,E) the kept claims' one-hot, and ``aux``."""
    B, S, E = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    gate_vals, expert_idx = _top_k(probs, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    onehot = F.one_hot(expert_idx, E).float()  # (B,S,k,E)
    flat = onehot.reshape(B, S * k, E)
    pos = torch.cumsum(flat, dim=1) - flat
    keep = flat * (pos < capacity)
    f = F.one_hot(expert_idx[..., 0], E).float().mean(dim=(0, 1))
    share = 1.0
    if stats is not None:
        f, share = stats(f, key), stats.share
    aux = E * torch.sum(f * probs.mean(dim=(0, 1)))
    if share != 1.0:
        aux = aux * share
    return {"expert_idx": expert_idx, "gate_vals": gate_vals, "onehot": onehot, "pos": pos,
            "keep": keep, "aux": aux}


def top_k_routing(router_logits, k: int, capacity: int, dtype=torch.float32, stats=None,
                  key=None):
    """Dispatch and combine tensors ``(B, S, E, C)`` in ``dtype`` from router
    logits (the einsum back-end's), and the router loss. A token holds at
    most one claim per expert, so the k dim collapses before any C-wide
    tensor exists."""
    out = _einsum_routing(router_logits, k, capacity, dtype, stats, key)
    claimed, gate_e, slotoh = out["claimed"], out["gate_e"], out["slotoh"]
    return (claimed.to(dtype)[..., None] * slotoh, gate_e.to(dtype)[..., None] * slotoh,
            out["aux"])


def _einsum_routing(router_logits, k, capacity, dtype, stats, key):
    B, S, E = router_logits.shape
    r = _route(router_logits, k, capacity, stats, key)
    keep4 = r["keep"].reshape(B, S, k, E)
    rank = (r["pos"].reshape(B, S, k, E) * keep4).sum(dim=2)  # (B,S,E)
    return {"claimed": keep4.amax(dim=2),
            "gate_e": torch.einsum("bske,bsk->bse", keep4, r["gate_vals"]),
            "slotoh": F.one_hot(rank.long(), capacity).to(dtype), "aux": r["aux"]}


def _router_logits(x, router_w):
    return (x @ router_w.to(x.dtype)).float()


def _combine(group, x, gates, w_gate, w_up, w_down, partial):
    """The layer's output. Whole weights: ``partial(x, gates, 0, w_gate,
    w_up, w_down)``. Pieces of the expert group (each ``E / ep`` experts
    from expert ``group.expert_index(j) * E / ep``): each piece's partial
    FFN on ``x`` and ``gates`` through ``group.copy``, summed by
    ``group.reduce``."""
    if not isinstance(w_gate, (list, tuple)):
        return partial(x, gates, 0, w_gate, w_up, w_down)
    n = w_gate[0].shape[0]
    xs, gs = group.copy(x), group.copy(gates)
    return group.reduce([partial(xr, gr, group.expert_index(j) * n, wg, wu, wd)
                         for j, (xr, gr, wg, wu, wd)
                         in enumerate(zip(xs, gs, w_gate, w_up, w_down))])


def _swiglu(t, wg, wu, wd, spec):
    """``(silu(t·wg) * (t·wu))·wd`` as einsums over a leading expert dim."""
    a, b = spec
    gated = F.silu(torch.einsum(a, t, wg)) * torch.einsum(a, t, wu)
    return torch.einsum(b, gated, wd)


def moe_ffn_einsum(x, router_w, w_gate, w_up, w_down, *, k: int, capacity_factor: float = 1.25,
                   group=None, stats=None, key=None):
    """The dense one-hot einsum layer (GShard). x (B,S,h), router_w (h,E),
    w_gate/w_up (E,h,i), w_down (E,i,h), or pieces of them (module
    docstring). Returns ``(out (B,S,h), aux)``."""
    B, S, h = x.shape
    E = router_w.shape[-1]
    dt = x.dtype
    capacity = router_capacity(S, E, k, capacity_factor)
    r = _einsum_routing(_router_logits(x, router_w), k, capacity, dt, stats, key)
    claimed, slotoh = r["claimed"], r["slotoh"]

    def partial(xr, gate_e, e0, wg, wu, wd):
        sl = slice(e0, e0 + wg.shape[0])
        so = slotoh[:, :, sl]
        dispatch = claimed[:, :, sl].to(dt)[..., None] * so
        combine = gate_e[:, :, sl].to(dt)[..., None] * so
        expert_in = torch.einsum("bsec,bsh->ebch", dispatch, xr)
        expert_out = _swiglu(expert_in, wg.to(dt), wu.to(dt), wd.to(dt),
                             ("ebch,ehi->ebci", "ebci,eih->ebch"))
        return torch.einsum("ebch,bsec->bsh", expert_out, combine)

    return _combine(group, x, r["gate_e"], w_gate, w_up, w_down, partial), r["aux"]


def moe_ffn_indexed(x, router_w, w_gate, w_up, w_down, *, k: int,
                    capacity_factor: float = 1.25, group=None, stats=None, key=None):
    """The gather-based capacity-slot layer: the claim ranks scattered into
    a ``(B, E, C)`` slot-to-token map (unfilled slots read token 0 and are
    never combined), tokens gathered into ``(E, B, C, h)`` slots, the dense
    expert einsums, and each claim's output slot gathered back, weighted by
    its gate (0 when dropped). Same arguments and result as
    :func:`moe_ffn_einsum`."""
    B, S, h = x.shape
    E = router_w.shape[-1]
    dt = x.dtype
    capacity = router_capacity(S, E, k, capacity_factor)
    r = _route(_router_logits(x, router_w), k, capacity, stats, key)
    Sk = S * k
    e_j = r["expert_idx"].reshape(B, Sk)
    p_j = r["pos"].gather(2, e_j[..., None])[..., 0].long()
    kept_j = r["keep"].sum(-1)  # (B, Sk) in {0, 1}
    dev = x.device
    tok_j = (torch.arange(Sk, device=dev) // k)[None].expand(B, Sk)
    b_idx = torch.arange(B, device=dev)[:, None].expand(B, Sk)
    p_sc = torch.where(kept_j > 0, p_j, torch.full_like(p_j, capacity))
    slot_tok = torch.zeros((B, E, capacity + 1), dtype=torch.long, device=dev)
    slot_tok[b_idx, e_j, p_sc] = tok_j  # dropped claims land in the spare column
    slot_tok = slot_tok[..., :capacity]
    gates = r["gate_vals"].reshape(B, Sk) * kept_j

    def partial(xr, g, e0, wg, wu, wd):
        n = wg.shape[0]
        idx = slot_tok[:, e0:e0 + n].reshape(B, n * capacity)
        expert_in = torch.gather(xr, 1, idx[..., None].expand(B, n * capacity, h))
        expert_in = expert_in.reshape(B, n, capacity, h).transpose(0, 1)
        expert_out = _swiglu(expert_in, wg.to(dt), wu.to(dt), wd.to(dt),
                             ("ebch,ehi->ebci", "ebci,eih->ebch"))
        eo = expert_out.transpose(0, 1).reshape(B, n * capacity, h)
        local = (e_j >= e0) & (e_j < e0 + n)
        flat = (e_j - e0).clamp(0, n - 1) * capacity + p_j.clamp(0, capacity - 1)
        y = torch.gather(eo, 1, flat[..., None].expand(B, Sk, h))
        w = (g * local).to(dt)
        return (y * w[..., None]).reshape(B, S, k, h).sum(dim=2)

    return _combine(group, x, gates, w_gate, w_up, w_down, partial), r["aux"]


def moe_ffn_sorted(x, router_w, w_gate, w_up, w_down, *, k: int, capacity_factor: float = 1.25,
                   group=None, stats=None, key=None):
    """The sort-by-expert layer: claims grouped by expert by a counting sort
    (``dest = expert_base + row_base + rank``, the order of a stable sort by
    (expert, batch row, claim)), the token rows moved by a gather through
    the inverse permutation, each expert's FFN one matmul over its
    contiguous rows (the group sizes read on the host once a layer), and
    the combine a gather of each claim's row, weighted by its gate (0 when
    dropped). Same arguments and result as :func:`moe_ffn_einsum`."""
    B, S, h = x.shape
    E = router_w.shape[-1]
    dt = x.dtype
    capacity = router_capacity(S, E, k, capacity_factor)
    r = _route(_router_logits(x, router_w), k, capacity, stats, key)
    gates = r["gate_vals"] * r["keep"].reshape(B, S, k, E).sum(-1)  # dropped -> 0
    Sk, N = S * k, B * S * k
    e_claim = r["expert_idx"].reshape(B, Sk)
    rank = r["pos"].gather(2, e_claim[..., None])[..., 0].long()
    counts = r["onehot"].reshape(B, Sk, E).sum(dim=1).long()  # (B, E)
    row_base = torch.cumsum(counts, 0) - counts
    group_sizes = counts.sum(0)
    expert_base = torch.cumsum(group_sizes, 0) - group_sizes
    dest = (expert_base[e_claim] + row_base.gather(1, e_claim) + rank).reshape(N)
    inv = torch.empty(N, dtype=torch.long, device=x.device).scatter_(
        0, dest, torch.arange(N, device=x.device))
    bounds = [0]
    for n in group_sizes.tolist():  # the layer's one device-to-host read
        bounds.append(bounds[-1] + n)

    def partial(xr, g, e0, wg, wu, wd):
        n = wg.shape[0]
        lo, hi = bounds[e0], bounds[e0 + n]
        rows = xr.reshape(B * S, h)[inv[lo:hi] // k]
        outs = []
        for e in range(n):
            seg = rows[bounds[e0 + e] - lo:bounds[e0 + e + 1] - lo]
            outs.append((F.silu(seg @ wg[e].to(dt)) * (seg @ wu[e].to(dt))) @ wd[e].to(dt))
        sorted_out = torch.cat([rows.new_zeros((lo, h)), *outs, rows.new_zeros((N - hi, h))])
        y = sorted_out[dest].reshape(B, S, k, h)
        return (y * g[..., None].to(dt)).sum(dim=2)

    return _combine(group, x, gates, w_gate, w_up, w_down, partial), r["aux"]


BACKENDS = {"sorted": moe_ffn_sorted, "einsum": moe_ffn_einsum, "indexed": moe_ffn_indexed}


def expert_parallel_size(group, w_gate) -> int:
    """How many ep ranks the experts split over: 1 for whole weights."""
    if not isinstance(w_gate, (list, tuple)) or group is None:
        return 1
    return group.size // group.minor


def dispatch_impl(seq_len: int, capacity_factor: float, ep: int = 1) -> str:
    """The back-end :func:`moe_ffn` runs (module docstring)."""
    impl = os.environ.get(DISPATCH_ENV, "auto")
    if impl == "auto":
        if ep > 1:
            return "einsum"
        return "einsum" if (seq_len <= 2048 and capacity_factor <= 2.0) else "sorted"
    if impl not in BACKENDS:
        raise ValueError(f"{DISPATCH_ENV}={impl!r} is not a dispatch back-end "
                         f"(valid: auto|{'|'.join(sorted(BACKENDS))})")
    return impl


def moe_ffn(x, router_w, w_gate, w_up, w_down, *, k: int, capacity_factor: float = 1.25,
            group=None, stats=None, key=None):
    """Route, run the experts, combine, with the back-end of
    :func:`dispatch_impl`. Returns ``(out, aux)``."""
    impl = dispatch_impl(x.shape[1], capacity_factor, expert_parallel_size(group, w_gate))
    return BACKENDS[impl](x, router_w, w_gate, w_up, w_down, k=k,
                          capacity_factor=capacity_factor, group=group, stats=stats, key=key)
