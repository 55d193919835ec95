"""Ring attention over view-sharded keys: the sequence-parallel seq axis
(the JAX package's parallel/ring.py).

When the input views outgrow one card, seq rank s of S holds views
[s V/S, (s + 1) V/S) of every scene: a ringed encoder runs on them alone (the
conv stem, the tokens' LayerNorms and MLPs, its self-attention's queries
and keys; tokens are view-major, so a rank's tokens are one contiguous
block), and z stays view-sharded. A ringed decoder's queries (the target
rays) are whole on every seq rank, and their cross-attention rings the
input views' keys and values.

GTA's rep transforms run locally (ops/gta.gta_transform_qkv and
gta_untransform_out, as JAX's run inside its shard_map): every key-side
table is indexed by view (se3_k, so3_k) or token (so2_k, t2_k), so a rank's
tables are those of its views, and only transformed keys and values ride
the ring. The encoder's query-side tables are its views' too; the
decoder's are whole. `local_views` slices a batch's input fields to the
rank's views, and the model builds both sides' contexts from that batch.

The core (`ring_attention`) is JAX's fold: an online softmax in fp32 over
one block of keys per step, in plain torch products (JAX computes it in XLA
einsums, not in a Pallas kernel), the next block in flight to the next rank
(`dist.batch_isend_irecv`) while the current one folds. Its backward is an
autograd Function that recomputes p = exp(s - lse) with the global lse and
takes delta = rowsum(do o) from the global output; it never launches
flash_core_bwd, whose instances assume they see every key of a row. Where
the queries are sharded (the encoder) the blocks travel again, each with
its dk and dv, until they are back on the rank that owns them, and dq
accumulates locally. Where the queries are whole on every rank (the
decoder) every rank would add the same terms to a travelling block, so
each rank takes its own block's dk and dv alone and the partial dq sums
over the ring; its forward folds the blocks in an order that starts at
the rank's own, so rank 0's output (and lse) is broadcast to keep the
replicas' bits one.

Scope: a module (the encoder's self-attention, the decoder's
cross-attention) rings exactly where JAX's would: its config rings
(config.with_ring_attention: the production GTA variant with a static
tau, no euclid_sim, no elementwise_mul, no attention map returned;
gta_tpu/config.py:283, gta_tpu/models/layers.py:181) and the shapes divide
(gta_tpu/parallel/ring.py:122 `shapes_divide`: the seq ranks divide the
input views, and, under tensor parallel, the model ranks its heads).
Otherwise the module runs whole, on every view, on each seq rank, as JAX
runs it replicated (`rings`, `describe`). The SRT model carries z between
the two layouts (models/srt.py): a whole decoder after a ringed encoder
takes z gathered over the seq axis (dist.gather_blocks; its backward keeps
the rank's block of the gradient, which every rank's whole decoder holds
in full), a ringed decoder after a whole encoder the rank's block of z
(dist.own_block; its backward gathers the blocks' gradients, so the
encoder's is whole). FTL transforms z in the decoder's layout, by the
input transforms of the views it holds.

Gradients: a parameter used on view-sharded activations has a partial
gradient on each seq rank, which the trainer sums over the seq axis
(`seq_partial_names`: the encoder's parameters where it rings, the
decoder's to_kv and FTL's trans_coeff where the decoder rings); one used
on whole activations (a whole module's, and a ringed decoder's query path:
to_q, to_out, the FeedForwards, LayerNorms and MLPs) has its whole
gradient on every rank and is not summed again. A ringed decoder's
trans_coeff is used on both sides: its key-side use enters through
tp.copy_in over the seq axis, so its gradient is whole on every rank.
Dropout on a view-sharded activation draws the whole activation's mask and
keeps the rank's rows (models/layers.Dropout.shards).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn

from gta_tpu_torch.config import GTAArgs
from gta_tpu_torch.models.context import SceneBatch
from gta_tpu_torch.ops.gta import gta_transform_qkv, gta_untransform_out
from gta_tpu_torch.ops.reps import GeomReps
from gta_tpu_torch.parallel import dist as pdist
from gta_tpu_torch.parallel.tp import copy_in

INPUT_FIELDS = ("input_images", "input_camera_pos", "input_rays", "input_transforms", "input_coord",
                "input_org_rays", "org_input_images")


def _fold_block(qf, kc, vc, scale, o, m, l):
    """One block of keys folded into the running (o, m, l) in fp32
    (gta_tpu/parallel/ring.py:58-66)."""
    s = torch.matmul(qf, kc.float().transpose(-1, -2)) * scale
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    return o * alpha + torch.matmul(p, vc.float()), m_new, l * alpha + p.sum(-1, keepdim=True)


def _block_grads(qf, dof, kc, vc, lse, delta, scale):
    """(dq, dk, dv) of one block of keys, fp32, from the global lse and
    delta."""
    kf, vf = kc.float(), vc.float()
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    return torch.matmul(ds, kf) * scale, torch.matmul(ds.transpose(-1, -2), qf) * scale, dv


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, axis, q_sharded):
        qf = q.float()
        o = torch.zeros_like(qf)
        m = torch.full(qf.shape[:-1] + (1,), -torch.inf, device=q.device)
        l = torch.zeros_like(m)
        kv = torch.stack([k, v])
        for t in range(axis.size):
            wait = pdist.ring_exchange(kv, axis) if t < axis.size - 1 else None
            o, m, l = _fold_block(qf, kv[0], kv[1], scale, o, m, l)
            if wait is not None:
                kv = wait()
        o = o / l
        lse = m + torch.log(l)
        if not q_sharded:  # one set of bits for the replicas
            ol = torch.cat([o, lse], -1)
            pdist.broadcast_(ol, axis.ranks[0], axis)
            o, lse = ol[..., :-1], ol[..., -1:]
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.axis, ctx.q_sharded = scale, axis, q_sharded
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        scale, axis = ctx.scale, ctx.axis
        qf, dof = q.float(), do.float()
        delta = torch.sum(dof * o, -1, keepdim=True)
        if not ctx.q_sharded:
            dq, dk, dv = _block_grads(qf, dof, k, v, lse, delta, scale)
            pdist.all_reduce_(dq, axis)
            return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None
        dq = torch.zeros_like(qf)
        kv = torch.stack([k, v])
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=kv.device)
        for t in range(axis.size):
            wait = pdist.ring_exchange(kv, axis) if t < axis.size - 1 else None
            dq_b, dk_b, dv_b = _block_grads(qf, dof, kv[0], kv[1], lse, delta, scale)
            dq += dq_b
            dkv = dkv + torch.stack([dk_b, dv_b])
            dkv = pdist.ring_exchange(dkv, axis)()  # the block's gradients travel with it, home after S passes
            if wait is not None:
                kv = wait()
        return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype), None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, axis: pdist.Axis,
                   q_sharded: bool) -> torch.Tensor:
    """softmax(q k^T scale) v over heads-first [B, H, T, C] operands, k and
    v this rank's block of keys over `axis`; q this rank's block of queries
    (q_sharded) or every query, whole on every rank. Returns the local
    [B, H, Tq, C] output in q's dtype."""
    return _Ring.apply(q, k, v, float(scale), axis, q_sharded)


def ring_gta_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, reps: GeomReps, args: GTAArgs,
                       trans_coeff: Optional[torch.Tensor], scale: float, axis: pdist.Axis,
                       self_att: bool) -> torch.Tensor:
    """GTA attention with view-sharded keys (gta_tpu/parallel/ring.py:213):
    the transforms on this rank's tables, the core round the ring, the
    output's inverse transform. `reps` is the local GeomReps (key side: the
    rank's views; query side: its views in self-attention, every query
    otherwise). Equal to ops/gta.gta_attention on the gathered arrays."""
    if args.euclid_sim or args.elementwise_mul:
        raise ValueError("the ring covers the production GTA variant only (no euclid_sim, no elementwise_mul)")
    tc_k = trans_coeff if self_att else copy_in(trans_coeff, axis)
    qt, kt, vt = gta_transform_qkv(q, k, v, reps, args, trans_coeff, trans_coeff_k=tc_k)
    out = ring_attention(qt, kt, vt, scale, axis, q_sharded=self_att)
    if args.v_transform:
        out = gta_untransform_out(out, reps, args, trans_coeff)
    return out


def local_views(batch: SceneBatch, axis: pdist.Axis) -> SceneBatch:
    """`batch` with its input-view fields cut to seq rank `axis.index`'s
    views (the targets as they are)."""
    n = batch.input_images.shape[1] // axis.size
    lo = axis.index * n
    return dataclasses.replace(batch, **{f: None if (x := getattr(batch, f)) is None else x[:, lo : lo + n]
                                         for f in INPUT_FIELDS})


def rings(mod_cfg, n_views: int, n_seq: int, n_model: int = 1) -> bool:
    """Whether a module (an EncoderConfig or DecoderConfig) rings over
    `n_seq` seq ranks (module docstring): its config rings, and the
    shapes divide."""
    return mod_cfg.attn.ring and n_views % n_seq == 0 and mod_cfg.heads % n_model == 0


def describe(model: nn.Module, n_seq: int) -> str:
    """Which modules of `model` ring over `n_seq` seq ranks and which run
    whole on each."""
    state = {name: "rings" if on else "whole" for name, on in
             (("encoder", model.ring_encoder), ("decoder", model.ring_decoder))}
    return f"sequence parallel over {n_seq} seq ranks: encoder {state['encoder']}, decoder {state['decoder']}"


def shard_model(model: nn.Module, axis: pdist.Axis, n_views: int, n_model: int = 1) -> List[str]:
    """Route `model` (an SRT, its config through with_ring_attention)
    round the seq axis: each module that `rings` runs its GTA attention
    round the ring on the rank's views (the encoder's dropout masks cut to
    the rank's rows), the others run whole. Returns the names of the
    parameters whose gradients are partial over the seq ranks
    (`seq_partial_names`)."""
    from gta_tpu_torch.models.layers import Attention, Dropout

    cfg = model.cfg
    model.ring_encoder = rings(cfg.encoder, n_views, axis.size, n_model)
    model.ring_decoder = rings(cfg.decoder, n_views, axis.size, n_model)
    if model.ring_encoder or model.ring_decoder:
        model.seq = axis
    if model.ring_encoder:
        for m in model.encoder.modules():
            if isinstance(m, Attention):
                m.seq = axis
            elif isinstance(m, Dropout):
                m.shards = m.shards + ((1, axis.index, axis.size),)
    if model.ring_decoder:
        for m in model.decoder.modules():
            if isinstance(m, Attention):
                m.seq = axis
    return seq_partial_names(model)


def seq_partial_names(model: nn.Module) -> List[str]:
    """The parameters used on view-sharded activations: the encoder's
    where it rings; where the decoder rings, its to_kv (the key side of its
    cross-attention) and FTL's trans_coeff (z's transform)."""
    names = []
    for name, _ in model.named_parameters():
        if model.ring_encoder and name.startswith("encoder."):
            names.append(name)
        elif model.ring_decoder and ((name.startswith("decoder.") and ".to_kv." in name) or name == "trans_coeff"):
            names.append(name)
    return names
