"""Expert-parallel MoE via boundary all-to-all — the nFFT schedule reused.

The paper's insight: place data so the hot GEMM is purely local and pay a
single re-partitioning collective at the stage *boundary*. For MoE that is
exactly expert parallelism:

    tokens (sharded dp x model)  --a2a-->  expert-major buffers (local E/N)
            expert FFN: LOCAL matmuls, zero collectives (the hot stage)
    expert outputs               --a2a-->  token-major, combine at source

vs. the TP-MoE default in ``models/layers.moe_forward`` (d_ff sharded,
all-reduce in the hot stage — the "wFFT" of MoE).

The one explicit per-rank body of the port, as ``shard_map`` is in the
reference: each rank takes its token block and its experts' blocks
(``to_local``), routes its tokens, packs fixed-capacity per-(dest-rank,
local-expert) buffers, exchanges them across the ``model`` axis
(``all_to_all_single`` on its group), runs its local experts, and
exchanges the results back.  Capacity overflow drops (standard
token-choice semantics).  Differentiable: the backward of an exchange is
the same exchange of the gradient.  Each exchange of a forward is counted
in ``conv.stage_trace`` as ``("collective", "all_to_all")``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as TF

from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig
from repro_torch.parallel.act_sharding import (P, axis_sizes, dp_axes,
                                               local_of, placements)


class _Exchange(torch.autograd.Function):
    """One all-to-all of equal blocks along dim 0 over ``group``: block j
    goes to rank j, and the block from rank i lands at i.  It is its own
    transpose, so the backward exchanges the gradient the same way."""

    @staticmethod
    def forward(ctx, send, group):
        ctx.group = group
        return _exchange(send, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group), None


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose backward scales the gradient."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def _exchange(send, group):
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv


def exchange(send, group):
    """The boundary all-to-all of ``send`` (n_ranks, ...), counted."""
    from repro_torch.conv.stages import _record
    _record("all_to_all", send)
    return _Exchange.apply(send, group)


def _ep_body(w_router, w1, w2, w3, x, *, cfg: ModelConfig, n_ranks: int,
             group, cap: int):
    """Per-rank body. x: (Tl, d) local tokens; w1/w2/w3: (E_loc, ...) local
    experts; w_router: (d, E) replicated. Returns (Tl, d)."""
    Tl, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    E_loc = E // n_ranks
    cdt, dev = x.dtype, x.device

    logits = (x @ w_router.to(cdt)).float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, K, dim=-1)         # (Tl, K)
    if cfg.renorm_topk:
        topw = topw / torch.sum(topw, dim=-1, keepdim=True)

    flat_e = topi.reshape(-1)                         # (Tl*K,) global expert
    flat_t = torch.arange(Tl, device=dev).repeat_interleave(K)
    flat_w = topw.reshape(-1)
    order = torch.argsort(flat_e, stable=True)        # as jnp.argsort
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    # bincount's integers at a static shape, as ``layers._moe_group``
    counts = torch.zeros(E, dtype=se.dtype, device=dev).scatter_add_(
        0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(Tl * K, device=dev) - starts[se]
    keep = pos < cap
    # slot within the (dest_rank, local_expert, capacity) send buffer
    slot = torch.where(keep, se * cap + pos, E * cap)

    # kept slots are distinct; every overflow row lands in the scratch
    # row, which is cut off
    send = torch.zeros((E * cap + 1, d), dtype=cdt, device=dev).index_put(
        (slot,), x[st] * keep[:, None].to(cdt))[:E * cap]
    send = send.reshape(n_ranks, E_loc * cap, d)
    # ---- boundary a2a #1: token-major -> expert-major --------------------
    recv = exchange(send, group)
    # recv: (n_ranks_src, E_loc, cap, d) -> (E_loc, n_ranks_src*cap, d)
    recv = recv.reshape(n_ranks, E_loc, cap, d).transpose(0, 1) \
        .reshape(E_loc, n_ranks * cap, d)

    # ---- HOT STAGE: local expert FFN, zero collectives -------------------
    if cfg.mlp in ("swiglu", "geglu"):
        act = TF.silu if cfg.mlp == "swiglu" else L._gelu
        h = act(torch.einsum("ecd,edf->ecf", recv, w1.to(cdt))) * \
            torch.einsum("ecd,edf->ecf", recv, w2.to(cdt))
    else:
        h = L._gelu(torch.einsum("ecd,edf->ecf", recv, w1.to(cdt)))
    eo = torch.einsum("ecf,efd->ecd", h, w3.to(cdt))

    # ---- boundary a2a #2: expert-major -> token-major ---------------------
    back = eo.reshape(E_loc, n_ranks, cap, d).transpose(0, 1) \
        .reshape(n_ranks, E_loc * cap, d)
    got = exchange(back, group).reshape(E * cap, d)

    gathered = got[torch.clamp(slot, max=E * cap - 1)]
    contrib = gathered * (sw * keep).to(cdt)[:, None]
    return torch.zeros((Tl, d), dtype=cdt, device=dev).index_add(
        0, st, contrib)


def moe_forward_ep(p, x, cfg: ModelConfig, mesh, *, model_axis="model"):
    """Expert-parallel MoE. x: (B, S, d) global; expert weights sharded on
    the expert dim over ``model_axis``; tokens sharded (B over dp, S over
    model; an axis that does not divide goes unsharded).  Returns a
    ``DTensor`` placed (b_ax, s_ax, None).  Shared experts (deepseek) run
    as dense TP outside the a2a."""
    from torch.distributed.tensor import DTensor
    from torch._prims_common import make_contiguous_strides_for
    sizes = axis_sizes(mesh)
    n_ranks = sizes[model_axis]
    if cfg.n_experts % n_ranks:
        raise ValueError(f"{cfg.n_experts} experts do not divide over "
                         f"{n_ranks} ranks of {model_axis!r}")
    B, S, d = x.shape
    dp = dp_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    Tl = (B // dp_size if B % dp_size == 0 else B) \
        * (S // n_ranks if S % n_ranks == 0 else S)
    cap = int(min(Tl, max(8, round(Tl * cfg.top_k / cfg.n_experts
                                   * cfg.capacity_factor))))

    b_ax = dp if B % dp_size == 0 else None
    s_ax = model_axis if S % n_ranks == 0 else None
    x_spec = P(b_ax, s_ax, None)
    expert = P(model_axis, None, None)
    # the ranks of the DP axes (when B divides) and of ``model`` compute
    # for other tokens; where S does not divide, every rank of ``model``
    # routes all of them, and each expert gets n_ranks copies of each
    # token: the output's cotangent is split among them
    partial = (dp if b_ax else ()) + (model_axis,)
    x_loc = local_of(x, mesh, x_spec, partial)
    Bl, Sl, _ = x_loc.shape
    out = _ep_body(local_of(p["w_gate_router"], mesh, P(), partial),
                   local_of(p["w1"], mesh, expert, partial),
                   local_of(p["w2"], mesh, expert, partial),
                   local_of(p["w3"], mesh, expert, partial),
                   x_loc.reshape(Bl * Sl, d), cfg=cfg, n_ranks=n_ranks,
                   group=mesh.get_group(model_axis), cap=cap)
    if s_ax is None and n_ranks > 1:
        out = _ScaleGrad.apply(out, 1.0 / n_ranks)
    out = DTensor.from_local(out.reshape(Bl, Sl, d), mesh,
                             placements(x_spec, mesh, 3), run_check=False,
                             shape=x.shape,
                             stride=make_contiguous_strides_for(x.shape))
    if cfg.n_shared:
        out = out + L.mlp_forward(p["shared"], x, cfg.mlp)
    return out
