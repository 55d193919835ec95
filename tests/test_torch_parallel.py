"""Tensor parallel, the view-sharded GTA ring and ZeRO-1 in the port: gloo
processes on the CPU against one process, under every layout the JAX
package runs.

One module fixture starts two worlds side by side, each this file run as a
script in every rank (a free localhost port each, each `communicate` under
its own timeout), and waits for both:
  - two ranks: one train step each under --n-model 2 (the shrunk flagship,
    with dropout 0 and with the flagship's dropout 0.01; the SRT baseline
    through flash_core's plain version; msn_so3 in bf16; every eager
    route: gbt, rpe, repast, elementwise_mul, ape's adjustable tau, a
    decoder that returns its map, msn gta_so3_euclid in bf16; the flagship
    at 3 heads, whose attention layers run whole), under --n-seq 2
    (dropout 0 and 0.01; SRT, gta_euclid and msn's 5 views whole on each
    seq rank; ftl_rope, whose decoder alone rings; a map decoder after a
    ringed encoder) and under ZeRO-1 over two data ranks; the port's
    pixels under three layouts from the JAX package's weights; the ring
    GTA attention on numpy inputs (self- and cross-attention, the
    block-diagonal and the sliced transforms, 2 views a rank); then the
    train CLI under --n-seq 2 --accum 2 and one step under msn's CLIS;
  - four ranks: TP + ZeRO-1 + --accum 2 over 2 data x 2 model ranks, its
    checkpoint, a one-process checkpoint restored under that layout and
    saved again; the flagship at 2 heads under --n-model 4 (JAX's own
    case); the ring attention at one view a rank; then the train CLI
    under --n-model 2 --zero --accum 2 and one step under each other
    layout of CLIS.
Rank 0 of each world saves what the tests hold against the same calls in
one process here: the loss (rtol 1e-5), every parameter's gradient by name
(relative L2 <= 1e-5; a gradient that is zero but for round-off, against
the whole gradient's norm), the updated weights (atol 3e-5, the bound of
tests/test_ring.py:224). The shrunk flagship is that of
tests/test_torch_distributed.py (2 heads of 64, one attention block a side,
32x48 inputs, 48 target rays), lr_warmup 0. The workers import no JAX; the
ring attention's reference is the JAX package's dense gta_attention, and
the three layouts' its eval_step under its CPU mesh, computed here while
the ranks run. Apart from the worlds, every NVS config is built under a
model axis of 2 and 4 and a seq axis of 2, and what splits and rings is
held to the JAX package's rules.
"""
import contextlib
import dataclasses
import functools
import glob
import io
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml

from gta_tpu_torch.config import FDims, GTAArgs, load_config
from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
from gta_tpu_torch.models.srt import build_model
from gta_tpu_torch.parallel import dist as pdist
from gta_tpu_torch.parallel import tp
from gta_tpu_torch.train.checkpoint import Checkpointer
from gta_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "runs", "clevrtr", "GTA", "gta", "config.yaml")
SRT = os.path.join(ROOT, "runs", "clevrtr", "otherPEs", "srt", "config.yaml")
MSN_SO3 = os.path.join(ROOT, "runs", "msn", "GTA", "gta_so3", "config.yaml")
MSN_SO3_EUCLID = os.path.join(ROOT, "runs", "msn", "GTA", "gta_so3_euclid", "config.yaml")
GTA_EUCLID = os.path.join(ROOT, "runs", "clevrtr", "GTA", "gta_euclid", "config.yaml")
OTHER = {name: os.path.join(ROOT, "runs", "clevrtr", "otherPEs", name, "config.yaml")
         for name in ("gbt", "rpe", "repast", "elementwise_mul", "ape", "ftl_rope")}
B = 4  # the global batch
TIMEOUT = 150  # seconds, per communicate
GRAD_RTOL, WEIGHT_ATOL = 1e-5, 3e-5
ZERO_GRAD = 1e-9  # a gradient this small against the whole gradient is round-off (`round_off`)
BF16_RULE = 1.5  # chip_smoke.py's bf16 rule
# the ring attention's inputs (tests/test_ring.py's): B=2, H=2, 4 views of 6
# tokens, 2 target views of 5 rays; the sliced transforms (t2 in the mix)
# and the block-diagonal ones
RB, RH, NV, TPV, NQ, TQ = 2, 2, 4, 6, 2, 5
RING_ARGS = {"sliced": GTAArgs(f_dims=FDims(triv=2, se3=8, so3=8, so2=8, t2=6), so2=2, so3=2),
             "blockdiag": GTAArgs(f_dims=FDims(triv=8, se3=8, so3=8, so2=8), so2=2, so3=2)}
RING_FWD_TOL, RING_GRAD_TOL = 1e-6, 1e-5  # relative L2 from the dense fp32 reference: fp32 round-off


def shrink(path, heads=2, dropout=0.0, mixed_prec=None, attmap=False, loader=load_config, **training):
    """A config at the tests' width: `heads` heads of its head width, one
    attention block a side, 32x48 inputs (32x32 for msn), 48 target rays,
    lr_warmup 0; with `attmap`, a decoder that returns its last attention
    map. `loader` reads the YAML (the port's load_config, or the JAX
    package's)."""
    cfg = loader(path)
    m = cfg.model
    head = m.encoder.attdim // m.encoder.heads
    msn = m.encoder.heads == 8
    data = dataclasses.replace(cfg.data, dataset="synthetic", height=32, width=32 if msn else 48, downsample=0,
                               num_points=48)
    enc = dataclasses.replace(m.encoder, dim=64, attdim=heads * head, heads=heads, num_att_blocks=1, dropout=dropout)
    dec = dataclasses.replace(m.decoder, z_dim=heads * head, heads=heads, rmlp_dim=64, num_att_blocks=1,
                              dropout=dropout, return_last_attmap=attmap)
    if mixed_prec is not None:
        training["mixed_prec"] = mixed_prec
    return dataclasses.replace(cfg, data=data, model=dataclasses.replace(m, encoder=enc, decoder=dec),
                               training=dataclasses.replace(cfg.training, lr_warmup=0, **training))


# the train step cases: name -> (config, n_model, n_seq, zero)
CASES2 = {
    "tp": (lambda: shrink(FLAGSHIP), 2, 1, False),
    "tp_dropout": (lambda: shrink(FLAGSHIP, dropout=0.01), 2, 1, False),
    "tp_srt": (lambda: shrink(SRT), 2, 1, False),
    "tp_msn_bf16": (lambda: shrink(MSN_SO3, mixed_prec=True), 2, 1, False),
    "ring": (lambda: shrink(FLAGSHIP), 1, 2, False),
    "ring_dropout": (lambda: shrink(FLAGSHIP, dropout=0.01), 1, 2, False),
    "zero": (lambda: shrink(FLAGSHIP), 1, 1, True),
    # every layout the JAX package runs: tensor parallel over the eager
    # routes (gbt's bias, rpe's rep vectors, repast, elementwise_mul, ape's
    # adjustable tau, euclid in bf16, a decoder that returns its map) and
    # over heads it does not divide (3: the attention layers run whole,
    # the FeedForwards split); --n-seq for modules that do not ring (SRT;
    # ftl_rope's encoder, whose tau is learned, before its ringed decoder;
    # euclid; the map decoder after a ringed encoder; msn's 5 views)
    **{f"tp_{name}": (functools.partial(shrink, OTHER[name]), 2, 1, False)
       for name in ("gbt", "rpe", "repast", "elementwise_mul", "ape")},
    "tp_attmap": (lambda: shrink(FLAGSHIP, attmap=True), 2, 1, False),
    "tp_3heads": (lambda: shrink(FLAGSHIP, heads=3), 2, 1, False),
    "tp_msn_euclid_bf16": (lambda: shrink(MSN_SO3_EUCLID, mixed_prec=True), 2, 1, False),
    "seq_srt": (lambda: shrink(SRT), 1, 2, False),
    "seq_ftl_rope": (lambda: shrink(OTHER["ftl_rope"]), 1, 2, False),
    "seq_gta_euclid": (lambda: shrink(GTA_EUCLID), 1, 2, False),
    "seq_attmap": (lambda: shrink(FLAGSHIP, attmap=True), 1, 2, False),
    "seq_msn_so3": (lambda: shrink(MSN_SO3, mixed_prec=False), 1, 2, False),
}
CASES4 = {"tp_zero_accum2": (lambda: shrink(FLAGSHIP, grad_accum=2), 2, 1, True),
          "tp4_2heads": (lambda: shrink(FLAGSHIP), 4, 1, False)}
BF16_CASES = ("tp_msn_bf16", "tp_msn_euclid_bf16")
# the kernels' backward entries one step calls on each rank (the CPU runs
# their plain versions): a whole layer calls them as one process does, a
# split GTA or flash layer on its heads, the eager routes none (as JAX keeps
# them in XLA), the ring its own fold
BACKWARDS = {"tp_3heads": {"gta_fused_bwd": 2}, "tp4_2heads": {"gta_fused_bwd": 2}, "tp_attmap": {"gta_fused_bwd": 1},
             "seq_srt": {"flash_core_bwd": 2}, "seq_msn_so3": {"gta_fused_bwd": 2},
             **{name: {} for name in ("tp_gbt", "tp_rpe", "tp_repast", "tp_elementwise_mul", "tp_ape",
                                      "tp_msn_euclid_bf16", "seq_ftl_rope", "seq_gta_euclid", "seq_attmap")}}
# what splits and what rings in each new case: (encoder attention, encoder
# FeedForward, decoder attention, decoder FeedForward) split; (encoder,
# decoder) ring
LAYOUTS = {"tp_3heads": ((False, True, False, True), None), "tp4_2heads": ((False, True, False, True), None),
           "tp_attmap": ((True, True, True, True), None),
           "seq_srt": (None, (False, False)), "seq_ftl_rope": (None, (False, True)),
           "seq_gta_euclid": (None, (False, False)), "seq_attmap": (None, (True, False)),
           "seq_msn_so3": (None, (False, False))}
# the train CLI under each layout of the JAX package's that the port once
# refused, on its config's shrunk YAML: (world, config path, heads, flags);
# over four ranks, two data ranks beside the model or seq axis
CLIS = {"gbt_model2": (4, OTHER["gbt"], 2, "--n-model 2"), "3heads_model2": (4, FLAGSHIP, 3, "--n-model 2"),
        "srt_seq2": (4, SRT, 2, "--n-seq 2"), "ftl_rope_seq2": (4, OTHER["ftl_rope"], 2, "--n-seq 2"),
        "gta_euclid_seq2": (4, GTA_EUCLID, 2, "--n-seq 2"), "msn_so3_seq2": (2, MSN_SO3, 2, "--n-seq 2"),
        "2heads_model4": (4, FLAGSHIP, 2, "--n-model 4")}
# against the JAX package's eval_step under its CPU mesh: (config, n_model, n_seq)
JAX_CASES = {"gbt_model2": (lambda loader=load_config: shrink(OTHER["gbt"], loader=loader), 2, 1),
             "3heads_model2": (lambda loader=load_config: shrink(FLAGSHIP, heads=3, loader=loader), 2, 1),
             "srt_seq2": (lambda loader=load_config: shrink(SRT, loader=loader), 1, 2)}
JAX_PIXEL_ATOL = 1e-5


def items(cfg, rows):
    ds = SyntheticScenes(cfg.data, "train")
    return [ds[i] for i in rows]


def write_yaml(out_dir, path=FLAGSHIP, heads=2, name="config.yaml", **training):
    """A config shrunk as `shrink` shrinks it, `heads` heads of its head
    width, as a YAML (the train CLI rewrites its 64x96 frames to 32x48
    synthetic scenes), batch B, print_every 1, no periodic checkpoint,
    evaluation or render, lr_warmup 0."""
    with open(path) as f:
        raw = yaml.safe_load(f)
    raw["data"]["num_points"] = 48
    raw["data"]["kwargs"].update(height=64, width=96, downsample=1)
    enc, dec = raw["model"]["args"]["encoder_kwargs"], raw["model"]["args"]["decoder_kwargs"]
    m = load_config(path).model
    head = m.encoder.attdim // m.encoder.heads
    enc.update(dim=64, attdim=heads * head, heads=heads, num_att_blocks=1)
    dec.update(z_dim=heads * head, heads=heads, rmlp_dim=64, num_att_blocks=1)
    raw["training"].update({"batch_size": B, "print_every": 1, "checkpoint_every": 0, "backup_every": 0,
                            "validate_every": 0, "visualize_every": 0, "lr_warmup": 0, **training})
    path = os.path.join(str(out_dir), name)
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def whole_grads(trainer):
    """Every parameter's gradient by name, the model ranks' blocks gathered."""
    out = {}
    for name, p in trainer.model.named_parameters():
        g = p.grad
        if name in trainer.tp_specs:
            g = tp.gather_tensor(g, trainer.tp_specs[name], trainer.mesh.model)
        out[name] = g.detach().clone()
    return out


@contextlib.contextmanager
def counted_backwards(calls):
    """Count the calls of the attention kernels' backward entries (the
    fused GTA and flash_core ones, whose plain versions run on the CPU)
    into `calls`."""
    from gta_tpu_torch.ops import flash_core as fc, gta_fused as tgf

    saved = {(mod, name): getattr(mod, name) for mod, name in ((tgf, "gta_fused_bwd"), (fc, "flash_core_bwd"))}

    def counting(name, fn):
        def run(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return run

    for (mod, name), fn in saved.items():
        setattr(mod, name, counting(name, fn))
    try:
        yield calls
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def layout_of(trainer):
    """(which of the encoder's attention and FeedForward and the decoder's
    the model axis splits, (encoder rings, decoder rings)), each module
    kind's layers alike (else None)."""
    from gta_tpu_torch.models.layers import Attention, FeedForward

    split = []
    for module in (trainer.model.encoder, trainer.model.decoder):
        for kind in (Attention, FeedForward):
            flags = {m.tp is not None for m in module.modules() if isinstance(m, kind)}
            split.append(flags.pop() if len(flags) == 1 else None)
    return tuple(split), (trainer.model.ring_encoder, trainer.model.ring_decoder)


def masks_of(trainer, batch):
    """A map-returning decoder's masks on `batch` in eval mode (else None)."""
    if not trainer.cfg.model.decoder.return_last_attmap:
        return None
    with torch.no_grad():
        return trainer.model(batch)[1]["masks"].clone()


def step_case(cfg, n_model, n_seq, zero):
    """One train step under the layout, on this data rank's rows of the
    global batch; the whole state after it, the kernels' backward entries
    it called, what split and what rang, and a map decoder's masks before
    the step."""
    mesh = pdist.init_mesh(n_model, n_seq)
    trainer = Trainer(cfg, device="cpu", zero=zero, mesh=mesh)
    d, D = mesh.data.index, mesh.data.size
    batch = collate(items(cfg, range(d * B // D, (d + 1) * B // D)))
    masks = masks_of(trainer, batch)
    with counted_backwards({}) as calls:
        m = trainer.train_step(batch)
    return {"loss": float(m["loss"]), "mse": float(m["mse"]), "grad_norm": float(m["grad_norm"]),
            "grads": whole_grads(trainer), "state": trainer.state_dict(), "backwards": calls,
            "layout": layout_of(trainer), "masks": masks, "printed": trainer.layout()}, trainer


def jax_case(cfg, n_model, n_seq, weights):
    """The model's pixels and eval_step's MSE on the batch `jax_items`
    under the layout, from the whole weights `weights`."""
    trainer = Trainer(cfg, device="cpu", mesh=pdist.init_mesh(n_model, n_seq))
    trainer.load_model_state_dict(weights)
    batch = collate(jax_items(cfg))
    with torch.no_grad():
        pixels = trainer.model(batch)[0]
    return {"pixels": pixels.numpy(), "mse": trainer.eval_step(batch)["mse"].numpy()}


def jax_items(cfg):
    return [SyntheticScenes(cfg.data, "val")[i] for i in range(B)]


def random_se3(rng, n):
    """n random rigid transforms [n, 4, 4] (QR rotations, normal translations)."""
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        q, r = np.linalg.qr(rng.randn(3, 3))
        out[i, :3, :3] = q * np.sign(np.diag(r))
        out[i, :3, 3] = rng.randn(3)
    return out


def ring_inputs(args, seed=0):
    """numpy q, k, v, geometry and output cotangents for the ring attention."""
    rng = np.random.RandomState(seed)
    C = args.f_dims.total
    rays = rng.randn(RB, NV, TPV, 3).astype(np.float32)
    return {
        "coord": rng.rand(RB, NV, TPV, 2).astype(np.float32),
        "transforms": np.stack([random_se3(rng, NV) for _ in range(RB)]),
        "rays": rays / np.linalg.norm(rays, axis=-1, keepdims=True),
        "t_coord": rng.rand(RB, NQ, TQ, 2).astype(np.float32),
        "t_transforms": np.stack([random_se3(rng, NQ) for _ in range(RB)]),
        "q_self": (rng.randn(RB, RH, NV * TPV, C) * 0.3).astype(np.float32),
        "q_cross": (rng.randn(RB, RH, NQ * TQ, C) * 0.3).astype(np.float32),
        "k": (rng.randn(RB, RH, NV * TPV, C) * 0.3).astype(np.float32),
        "v": (rng.randn(RB, RH, NV * TPV, C) * 0.3).astype(np.float32),
        "g_self": rng.randn(RB, RH, NV * TPV, C).astype(np.float32),
        "g_cross": rng.randn(RB, RH, NQ * TQ, C).astype(np.float32),
        "tc": np.float32(0.01),
    }


def ring_case(n_seq):
    """The ring GTA attention over `n_seq` seq ranks: {(args, layout):
    (out, dq, dk, dv, dtc)}, outputs and gradients gathered whole."""
    from gta_tpu_torch.ops.reps import decoder_reps, encoder_reps
    from gta_tpu_torch.parallel.ring import ring_gta_attention

    axis = pdist.init_mesh(1, n_seq).seq
    n = NV // n_seq
    lo, hi = axis.index * n, (axis.index + 1) * n
    tok = slice(lo * TPV, hi * TPV)
    out = {}
    for key, args in RING_ARGS.items():
        x = {k: torch.from_numpy(np.asarray(v)) for k, v in ring_inputs(args).items()}
        enc = encoder_reps(args, x["coord"][:, lo:hi], x["transforms"][:, lo:hi], x["rays"][:, lo:hi])
        dec = decoder_reps(args, target_coord=x["t_coord"], target_transforms=x["t_transforms"],
                           input_coord=x["coord"][:, lo:hi], input_transforms=x["transforms"][:, lo:hi], enc=enc)
        for layout, reps in (("self", enc), ("cross", dec)):
            q = x[f"q_{layout}"][:, :, tok] if layout == "self" else x["q_cross"]
            g = x[f"g_{layout}"][:, :, tok] if layout == "self" else x["g_cross"]
            q, k, v = (t.clone().requires_grad_() for t in (q, x["k"][:, :, tok], x["v"][:, :, tok]))
            tc = x["tc"].clone().requires_grad_()
            o = ring_gta_attention(q, k, v, reps, args, tc, 0.5, axis, layout == "self")
            o.backward(g)
            dtc = tc.grad.clone()
            if layout == "self":  # the self-attention's trans_coeff gradient is partial over the seq ranks
                pdist.all_reduce_(dtc, axis)
            if layout == "self":
                gathered = [torch.cat(pdist.all_gather(t.detach(), axis), 2) for t in (o, q.grad)]
            else:  # the queries are whole on every rank
                gathered = [o.detach(), q.grad]
            kv = [torch.cat(pdist.all_gather(t.grad, axis), 2) for t in (k, v)]
            out[key, layout] = [t.numpy() for t in (*gathered, *kv, dtc)]
    return out


def _worker(world, out_dir, work_dir):
    """One rank of world `world` (2 or 4); rank 0 saves `<out_dir>/world<w>.pt`."""
    from gta_tpu_torch.train import __main__ as t_train

    torch.set_num_threads(1)
    assert pdist.init_from_env("cpu") == "cpu" and pdist.world() == world
    rank = pdist.rank()
    out = {}
    cases = CASES2 if world == 2 else CASES4
    t0 = time.perf_counter()
    for name, (make, n_model, n_seq, zero) in cases.items():
        out[name], trainer = step_case(make(), n_model, n_seq, zero)
        print(f"rank {rank}: {name} at {time.perf_counter() - t0:.1f} s", flush=True)
        if name == "tp_zero_accum2":
            sharded = trainer
    if world == 2:
        weights = torch.load(os.path.join(work_dir, "jax_weights.pt"), weights_only=True)
        out["jax"] = {name: jax_case(make(), n_model, n_seq, weights[name])
                      for name, (make, n_model, n_seq) in JAX_CASES.items()}
    if world == 4:
        # the TP + ZeRO-1 trainer's checkpoint, then a one-process checkpoint
        # restored under that layout and saved again
        Checkpointer(os.path.join(work_dir, "sharded")).save("latest", sharded, {"it": 0})
        restored = Trainer(CASES4["tp_zero_accum2"][0](), device="cpu", zero=True, mesh=sharded.mesh)
        Checkpointer(os.path.join(work_dir, "single")).restore("latest", restored)
        Checkpointer(os.path.join(work_dir, "resaved")).save("latest", restored)
    out["ring_attention"] = ring_case(world)
    printed = io.StringIO()
    cli = ["--n-seq", "2", "--accum", "2"] if world == 2 else ["--n-model", "2", "--zero", "--accum", "2"]
    with contextlib.redirect_stdout(printed):
        t_train.main([os.path.join(work_dir, "config.yaml"), "--synthetic", "--device", "cpu", "--outdir",
                      os.path.join(work_dir, "cli"), "--exit-after", "1", *cli])
    out["cli"] = printed.getvalue()
    out["clis"] = {}
    ports = iter(os.environ["CLI_PORTS"].split(","))  # the CLI ends its group: each run starts its own
    for name, (w, _, _, flags) in CLIS.items():
        if w != world:
            continue
        os.environ["MASTER_PORT"] = next(ports)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            t_train.main([os.path.join(work_dir, f"{name}.yaml"), "--synthetic", "--device", "cpu", "--outdir",
                          os.path.join(work_dir, f"cli_{name}"), "--exit-after", "0", *flags.split()])
        out["clis"][name] = printed.getvalue()
    if rank == 0:
        torch.save(out, os.path.join(out_dir, f"world{world}.pt"))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def jax_init(path):
    """{name: the JAX package's initial params of each JAX_CASES config,
    as the port's whole state_dict (params_from_jax)}, saved at `path`;
    returns the JAX params too."""
    import jax
    import jax.numpy as jnp

    from gta_tpu.config import load_config as j_load_config
    from gta_tpu.data.synthetic import collate as j_collate
    from gta_tpu.train.trainer import Trainer as JTrainer
    from gta_tpu_torch.weights import params_from_jax

    params = {}
    for name, (make, _, _) in JAX_CASES.items():
        batch = jax.tree.map(jnp.asarray, j_collate(jax_items(make())))
        params[name] = JTrainer(make(j_load_config)).init_state(batch, seed=0).params
    torch.save({name: params_from_jax(jax.tree.map(np.asarray, p)) for name, p in params.items()}, path)
    return params


def jax_eval(params):
    """{name: (pixels, eval_step's MSE)} of the JAX package under each
    JAX_CASES layout on its CPU mesh: make_mesh(n_data=1, ...), the
    parameters placed by its tensor parallel rules (parallel/tp.py), the
    ring attention where --n-seq asks for it (config.with_ring_attention,
    the ambient mesh), as train.py sets them up."""
    import jax
    import jax.numpy as jnp

    from gta_tpu.config import load_config as j_load_config, with_ring_attention as j_with_ring_attention
    from gta_tpu.data.synthetic import collate as j_collate
    from gta_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from gta_tpu.parallel.tp import shard_params
    from gta_tpu.train.trainer import Trainer as JTrainer

    out = {}
    for name, (make, n_model, n_seq) in JAX_CASES.items():
        jcfg = make(j_load_config)
        mesh = make_mesh(n_data=1, n_model=n_model, n_seq=n_seq)
        prev = jax.sharding.get_mesh()
        jax.set_mesh(mesh)
        try:
            jtr = JTrainer(j_with_ring_attention(jcfg) if n_seq > 1 else jcfg, mesh=mesh)
            p = shard_params(params[name], mesh) if n_model > 1 else replicate(params[name], mesh)
            batch = shard_batch(jax.tree.map(jnp.asarray, j_collate(jax_items(make()))), mesh)
            pixels = jax.jit(lambda p, b, jtr=jtr: jtr.model.apply(p, b, deterministic=True)[0])(p, batch)
            out[name] = (np.asarray(pixels), np.asarray(jtr.eval_step(p, batch)["mse"]))
        finally:
            jax.set_mesh(prev)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({world: what its rank 0 saved}, {world: its work directory}, the
    JAX package's JAX_CASES results). While the ranks run, the JAX
    references and the one-process steps the tests hold them against are
    made here."""
    out = tmp_path_factory.mktemp("parallel")
    work = {w: tmp_path_factory.mktemp(f"world{w}") for w in (2, 4)}
    for w in work.values():
        write_yaml(w)
    for name, (world, path, heads, _) in CLIS.items():
        write_yaml(work[world], path, heads, name=f"{name}.yaml")
    jparams = jax_init(os.path.join(work[2], "jax_weights.pt"))
    # the one-process checkpoint the four ranks restore
    cfg = CASES4["tp_zero_accum2"][0]()
    single = Trainer(cfg, device="cpu")
    single.train_step(collate(items(cfg, range(B))))
    Checkpointer(os.path.join(work[4], "single")).save("latest", single)
    procs = {}
    for world, wd in work.items():
        env = {**os.environ, "PYTHONPATH": os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]),
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()), "WORLD_SIZE": str(world),
               "OMP_NUM_THREADS": "1", "CLI_PORTS": ",".join(str(_free_port()) for _ in CLIS)}
        procs[world] = [subprocess.Popen([sys.executable, __file__, str(world), str(out), str(wd)], cwd=ROOT,
                                         env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                        for r in range(world)]
    logs = {}
    try:
        jax_out = jax_eval(jparams)
        for name, (make, *_) in {**CASES2, **CASES4}.items():
            one_process(make())
        for world, ps in procs.items():
            logs[world] = [p.communicate(timeout=TIMEOUT)[0] for p in ps]
    finally:
        for p in (p for ps in procs.values() for p in ps):
            if p.poll() is None:
                p.kill()
                p.communicate()
    for world, ps in procs.items():
        for r, p in enumerate(ps):
            assert p.returncode == 0, f"world {world} rank {r} exited {p.returncode}:\n{logs[world][r]}"
    return {w: torch.load(os.path.join(out, f"world{w}.pt"), weights_only=False) for w in work}, work, jax_out


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@functools.lru_cache(maxsize=None)
def one_process(cfg):
    """The one-process step on the whole batch: (metrics, grads, state);
    made once per config (the tests only read it)."""
    trainer = Trainer(cfg, device="cpu")
    m = trainer.train_step(collate(items(cfg, range(B))))
    grads = {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()}
    return {k: float(m[k]) for k in ("loss", "mse", "grad_norm")}, grads, trainer.state_dict()


def round_off(grads):
    """{name: bound} of the gradients that are zero but for round-off (a
    norm at most ZERO_GRAD of the whole gradient's: exact zeros, and rpe's
    q_bias and k_bias, whose products add one constant to every score of a
    row, which the softmax takes away), where a relative error means
    nothing: the bound is ZERO_GRAD of the whole gradient's norm."""
    whole = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values())))
    return {n: ZERO_GRAD * whole for n, g in grads.items() if float(torch.linalg.vector_norm(g)) <= ZERO_GRAD * whole}


def hold_step(got, cfg):
    """A parallel step's loss, gradients and updated weights against the
    one-process step's."""
    want, grads, state = one_process(cfg)
    for k in ("loss", "mse", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert got["grads"].keys() == grads.keys()
    noise = round_off(grads)
    for name, g in grads.items():
        assert got["grads"][name].shape == g.shape, name
        if name in noise:
            assert float(torch.linalg.vector_norm(got["grads"][name] - g)) <= noise[name], name
        else:
            err = rel_l2(got["grads"][name], g)
            assert err <= GRAD_RTOL, (name, err)
    for name, w in state["model"].items():
        np.testing.assert_allclose(got["state"]["model"][name], w, atol=WEIGHT_ATOL, rtol=0, err_msg=name)
    return state


@pytest.mark.parametrize("name", [n for n in CASES2 if n not in BF16_CASES] + list(CASES4))
def test_parallel_step_matches_one_process(runs, name):
    """TP (flagship with and without dropout, SRT through flash_core's plain
    version, every eager route, 3 heads over 2 ranks and 2 over 4: the
    attention layers whole), the ring (with and without dropout: every
    rank draws the whole activation's mask and keeps its block), --n-seq 2
    where modules run whole (SRT, euclid, msn's 5 views) or only one rings
    (ftl_rope's decoder, the encoder before a map decoder), ZeRO-1, and TP
    + ZeRO-1 + accum 2: loss, every gradient by name and the updated
    weights against one process; the moments gathered in the state equal
    one process's to the same bounds; a map decoder's masks (gathered over
    the model ranks' heads) equal one process's."""
    res, *_ = runs
    got = res[2 if name in CASES2 else 4][name]
    make = (CASES2 if name in CASES2 else CASES4)[name][0]
    state = hold_step(got, make())
    opt_got, opt_want = got["state"]["optimizer"], state["optimizer"]
    assert opt_got["param_groups"] == opt_want["param_groups"]
    assert opt_got["state"].keys() == opt_want["state"].keys()
    names = list(one_process(make())[1])  # the parameters in the optimizer's order
    noise = round_off(one_process(make())[1])
    for i, st in opt_want["state"].items():
        assert float(opt_got["state"][i]["step"]) == float(st["step"]) == 1.0
        for key in ("exp_avg", "exp_avg_sq"):
            assert opt_got["state"][i][key].shape == st[key].shape
            if names[i] in noise:  # moments of round-off: no larger than it
                diff = opt_got["state"][i][key] - st[key]
                assert float(torch.linalg.vector_norm(diff)) <= noise[names[i]], (i, key)
                continue
            err = rel_l2(opt_got["state"][i][key], st[key])
            assert err <= 2 * GRAD_RTOL, (i, key, err)
    if got["masks"] is not None:
        cfg = make()
        one = Trainer(cfg, device="cpu")
        np.testing.assert_allclose(got["masks"], masks_of(one, collate(items(cfg, range(B)))), atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", list(BACKWARDS))
def test_each_layout_splits_rings_and_reaches_the_kernels_as_jax(runs, name):
    """What splits and what rings in each new layout (LAYOUTS: 3 heads over
    2 model ranks and 2 over 4 run their attention whole and split their
    FeedForwards; SRT, euclid and msn's 5 views run whole on each seq rank;
    ftl_rope rings its decoder alone, the map decoder's model its encoder
    alone), what the ranks print of it, and the kernels' backward entries
    a rank's step calls (BACKWARDS: the eager routes none, as JAX keeps
    them in XLA)."""
    res, *_ = runs
    got = res[2 if name in CASES2 else 4][name]
    assert got["backwards"] == BACKWARDS[name]
    split, ring = LAYOUTS.get(name, ((True,) * 4, None))
    if name.startswith("tp"):
        assert got["layout"][0] == split
        assert got["printed"][0].startswith(f"tensor parallel over {CASES2.get(name, CASES4.get(name))[1]} model ranks")
    else:
        assert got["layout"] == ((False,) * 4, ring)
        state = {True: "rings", False: "whole"}
        assert got["printed"] == [f"sequence parallel over 2 seq ranks: encoder {state[ring[0]]}, "
                                  f"decoder {state[ring[1]]}"]


def test_the_ring_backward_calls_no_kernel_backward(runs):
    """The ring's backward is its own autograd Function: under --n-seq 2 a
    flagship step reaches neither flash_core_bwd nor gta_fused_bwd (their
    instances assume every key of a row), under --n-model 2 each layer
    calls gta_fused_bwd once (SRT: flash_core_bwd)."""
    res, *_ = runs
    for name in ("ring", "ring_dropout"):
        assert res[2][name]["backwards"] == {}, name
    assert res[2]["tp"]["backwards"] == {"gta_fused_bwd": 2}
    assert res[2]["tp_srt"]["backwards"] == {"flash_core_bwd": 2}


def hold_bf16(got, path):
    """A bf16 parallel step's gradient against the one-process steps of
    `path`'s shrunk config: its relative L2 from fp32 at most BF16_RULE x
    the one-process bf16 step's."""
    _, g16, _ = one_process(shrink(path, mixed_prec=True))
    _, g32, _ = one_process(shrink(path, mixed_prec=False))
    flat = lambda g: np.concatenate([g[n].numpy().ravel() for n in sorted(g32)])  # noqa: E731
    tp_err, own_err = rel_l2(flat(got["grads"]), flat(g32)), rel_l2(flat(g16), flat(g32))
    assert tp_err <= BF16_RULE * own_err, (tp_err, own_err)


def test_tp_bf16_sits_within_the_bf16_rule(runs):
    """msn_so3 (2 heads of 96, bf16) under --n-model 2: its gradient's
    relative L2 from the one-process fp32 step at most 1.5x that of the
    one-process bf16 step (its partial products summed in fp32, rounded
    once). Two bf16 steps whose sums run in different orders differ by
    about bf16's own error (a rounding that flips moves what follows), so
    the TP step is held to fp32, as chip_smoke.py holds the card's bf16."""
    res, *_ = runs
    hold_bf16(res[2]["tp_msn_bf16"], MSN_SO3)


def test_tp_euclid_bf16_sits_within_the_bf16_rule(runs):
    """msn gta_so3_euclid in bf16 under --n-model 2, its euclid attention
    in torch eager on the rank's heads (trans_coeff entering them through
    copy_in): the bf16 rule, as msn_so3's."""
    res, *_ = runs
    hold_bf16(res[2]["tp_msn_euclid_bf16"], MSN_SO3_EUCLID)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_layout_matches_jax_under_its_mesh(runs, name):
    """gbt and the flagship at 3 heads under --n-model 2, SRT under --n-seq
    2: the port's pixels from the JAX package's initial weights
    (params_from_jax) within JAX_PIXEL_ATOL of the JAX package's under the
    same layout on its CPU mesh, and eval_step's MSE within rtol 1e-5."""
    res, _, jax_out = runs
    got, (pixels, mse) = res[2]["jax"][name], jax_out[name]
    assert got["pixels"].shape == pixels.shape
    np.testing.assert_allclose(got["pixels"], pixels, atol=JAX_PIXEL_ATOL, rtol=0)
    np.testing.assert_allclose(got["mse"], mse, rtol=1e-5)


@pytest.fixture(scope="module")
def jax_dense():
    """{(args, layout): [out, dq, dk, dv, dtc]} of the JAX package's dense
    gta_attention on `ring_inputs` (jit-compiled, reps included)."""
    import functools

    import jax
    import jax.numpy as jnp

    from gta_tpu.config import FDims as JFDims, GTAArgs as JGTAArgs
    from gta_tpu.ops.attention import dot_product_attention
    from gta_tpu.ops.gta import gta_attention
    from gta_tpu.ops.reps import decoder_reps, encoder_reps

    out = {}
    for key, args in RING_ARGS.items():
        jargs = JGTAArgs(f_dims=JFDims(**dataclasses.asdict(args.f_dims)), so2=args.so2, so3=args.so3)
        for layout in ("self", "cross"):
            def ref(x, layout=layout, jargs=jargs):
                enc = encoder_reps(jargs, x["coord"], x["transforms"], x["rays"])
                reps = enc if layout == "self" else decoder_reps(
                    jargs, target_coord=x["t_coord"], target_transforms=x["t_transforms"], input_coord=x["coord"],
                    input_transforms=x["transforms"], enc=enc)

                def f(q, k, v, tc):
                    o, _ = gta_attention(q, k, v, functools.partial(dot_product_attention, scale=0.5), reps, jargs, tc)
                    return o

                o, vjp = jax.vjp(f, x[f"q_{layout}"], x["k"], x["v"], x["tc"])
                return [o, *vjp(x[f"g_{layout}"])]

            x = {k: jnp.asarray(v) for k, v in ring_inputs(args).items()}
            out[key, layout] = [np.asarray(t) for t in jax.jit(ref)(x)]
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("key", list(RING_ARGS))
@pytest.mark.parametrize("layout", ["self", "cross"])
def test_ring_gta_attention_matches_jax_dense(runs, jax_dense, world, key, layout):
    """The port's ring GTA attention over 2 (2 views a rank) and 4 seq
    ranks (one view a rank) against the JAX package's dense gta_attention
    on the same numpy inputs: the output, and the gradients of q, k, v and
    trans_coeff for a fixed cotangent, within RING_FWD_TOL / RING_GRAD_TOL
    relative L2 (fp32 round-off; the fold's order of summation differs)."""
    res, *_ = runs
    got, want = res[world]["ring_attention"][key, layout], jax_dense[key, layout]
    for name, g, w, tol in zip(("out", "dq", "dk", "dv", "dtc"), got, want, (RING_FWD_TOL,) + (RING_GRAD_TOL,) * 4):
        assert np.shape(g) == np.shape(w), name
        assert rel_l2(g, w) <= tol, (name, rel_l2(g, w))


def test_checkpoints_stay_whole_across_layouts(runs, tmp_path):
    """The checkpoint of the TP + ZeRO-1 step resumes in one process with
    bit-equal weights and moments (the gathered state); a one-process
    checkpoint restored under TP + ZeRO-1 and saved again is the same bits;
    scripts/export_reference_checkpoint exports the sharded run's."""
    from gta_tpu_torch.utils.ref_import import export_reference_checkpoint

    res, work, _ = runs
    gathered = res[4]["tp_zero_accum2"]["state"]
    cfg = CASES4["tp_zero_accum2"][0]()
    for name, want in (("sharded", gathered), ("resaved", None)):
        one = Trainer(cfg, device="cpu")
        Checkpointer(os.path.join(work[4], name)).restore("latest", one)
        if want is None:
            want = torch.load(os.path.join(work[4], "single", "ckpts", "latest", "state.pt"), weights_only=True)
        state = one.state_dict()
        assert state["step"] == want["step"] == 1 and state["scheduler"] == want["scheduler"]
        for k, w in want["model"].items():
            assert torch.equal(state["model"][k], w), (name, k)
        assert state["optimizer"]["param_groups"] == want["optimizer"]["param_groups"]
        for i, st in want["optimizer"]["state"].items():
            for key, w in st.items():
                assert torch.equal(state["optimizer"]["state"][i][key], w), (name, i, key)
    pt = os.path.join(str(tmp_path), "model.pt")
    export_reference_checkpoint(os.path.join(work[4], "config.yaml"), os.path.join(work[4], "sharded"), pt,
                                device="cpu")
    exported = torch.load(pt, weights_only=False)
    for key, w in gathered["model"].items():
        module, _, rest = key.partition(".")
        assert torch.equal(exported[module][rest], w), key


@pytest.mark.parametrize("world, flags", [(2, "--n-seq 2 --accum 2"), (4, "--n-model 2 --zero --accum 2")])
def test_train_cli_under_each_layout(runs, world, flags):
    """The train CLI under torchrun's environment: it names the backend and
    the mesh, trains, and writes a whole checkpoint a one-process trainer
    restores."""
    res, work, _ = runs
    printed = res[world]["cli"]
    assert f"Data parallel: backend gloo, world size {world}, rank 0" in printed
    mesh = "data 1 x seq 2 x model 1" if world == 2 else "data 2 x seq 1 x model 2"
    assert f"Mesh: {mesh}" in printed and f"ZeRO-1 {'on' if world == 4 else 'off'}" in printed
    assert "it=1, loss=" in printed and "Iteration limit reached. Exiting." in printed
    cfg = load_config(os.path.join(work[world], "config.yaml"))
    one = Trainer(cfg, device="cpu")
    Checkpointer(os.path.join(work[world], "cli")).restore("latest", one)
    assert one.step == 2 and all(torch.isfinite(p).all() for p in one.model.parameters())


@pytest.mark.parametrize("name", list(CLIS))
def test_train_cli_takes_a_step_under_every_jax_layout(runs, name):
    """The train CLI under each layout of the JAX package's that the port
    once refused (gbt and 3 heads under 2 data x 2 model ranks; SRT,
    ftl_rope and gta_euclid under 2 data x 2 seq ranks; msn's 5 views under
    --n-seq 2; 2 heads under --n-model 4): it lays the mesh out, every rank
    prints what splits or rings, and rank 0 trains a step and saves a
    whole checkpoint."""
    res, work, _ = runs
    world, _, _, flags = CLIS[name]
    printed = res[world]["clis"][name]
    n = int(flags.split()[-1])
    model, seq = (n, 1) if "--n-model" in flags else (1, n)
    assert f"Mesh: data {world // n} x seq {seq} x model {model}" in printed
    kind = "tensor parallel" if "--n-model" in flags else "sequence parallel"
    assert f"rank 0: {kind} over {n} " in printed
    assert "it=0, loss=" in printed and "Iteration limit reached. Exiting." in printed
    assert os.path.exists(os.path.join(work[world], f"cli_{name}", "ckpts", "latest"))


@pytest.mark.parametrize("flags, message", [
    (["--n-model", "3"], "world size 1 is not data x seq x model: --n-seq 1 x --n-model 3 does not divide it"),
    (["--n-seq", "3"], "world size 1 is not data x seq x model: --n-seq 3 x --n-model 1 does not divide it"),
    (["--n-model", "2"], "world size 1 is not data x seq x model"),
])
def test_train_cli_stops_at_start_on_a_layout_that_does_not_fit(tmp_path, capsys, flags, message):
    from gta_tpu_torch.train import __main__ as t_train

    path = write_yaml(tmp_path)
    env = {k: os.environ.pop(k) for k in ("WORLD_SIZE", "RANK") if k in os.environ}
    try:
        with pytest.raises(SystemExit):
            t_train.main([path, "--synthetic", "--device", "cpu", "--outdir", str(tmp_path), *flags])
    finally:
        os.environ.update(env)
    assert message in capsys.readouterr().err


# every NVS config (the DiTs have no SRT layers), under a model axis of 2
# and of 4 and a seq axis of 2
NVS_CONFIGS = sorted(p for p in glob.glob(os.path.join(ROOT, "runs", "*", "*", "*", "config.yaml"))
                     + glob.glob(os.path.join(ROOT, "experiments", "*", "config.yaml"))
                     if "/DiT/" not in p and "/dit_" not in p)
BUILD_LAYOUTS = {"model2": (2, 1), "model4": (4, 1), "seq2": (1, 2)}


def narrow(path):
    """The config at its published heads and widths, one attention block a
    side, a 64-wide conv stem and render MLP (what splits and what rings
    depends on neither)."""
    cfg = load_config(path)
    m = cfg.model
    enc = dataclasses.replace(m.encoder, dim=64, num_att_blocks=1)
    dec = dataclasses.replace(m.decoder, rmlp_dim=64, num_att_blocks=1)
    return dataclasses.replace(cfg, model=dataclasses.replace(m, encoder=enc, decoder=dec))


@pytest.mark.parametrize("layout", list(BUILD_LAYOUTS))
@pytest.mark.parametrize("path", NVS_CONFIGS, ids=[os.path.relpath(p, ROOT)[:-len("/config.yaml")] for p in NVS_CONFIGS])
def test_every_config_splits_and_rings_by_the_jax_rules(path, layout, monkeypatch):
    """A Trainer built under the layout (rank 0 of its axis, no step; the
    one place gbt once raised) splits an attention layer exactly where the
    model ranks divide its heads and a FeedForward where they divide its
    hidden units, whatever its method (rules A and B: JAX's GSPMD splits
    every method, its fused kernel falls back to the whole layer), and
    rings a module exactly where the JAX package's config rings it
    (gta_tpu.config.with_ring_attention), its tau is static
    (gta_tpu/models/layers.py:181) and the seq ranks divide the input
    views (rule C, JAX's shapes_divide); the split parameters are those of
    the layers that split, each a block of the published shape."""
    from gta_tpu.config import load_config as j_load_config, with_ring_attention as j_with_ring_attention
    from gta_tpu_torch.models.layers import Attention, FeedForward

    from gta_tpu_torch.train import trainer as t_trainer

    n_model, n_seq = BUILD_LAYOUTS[layout]
    axis = lambda n: pdist.Axis(n, 0, tuple(range(n))) if n > 1 else pdist.Axis()  # noqa: E731
    cfg = narrow(path)
    monkeypatch.setattr(t_trainer, "init_weights", lambda model, generator: model)  # the layout needs no draw
    trainer = Trainer(cfg, device="cpu", mesh=pdist.Mesh(pdist.Axis(), axis(n_seq), axis(n_model)))
    with torch.device("meta"):
        whole = build_model(cfg.model)
    jm = j_with_ring_attention(j_load_config(path)).model
    views = cfg.data.num_input_views
    for side, jmod, hidden in (("encoder", jm.encoder, jm.encoder.attdim * 2), ("decoder", jm.decoder, jm.decoder.ff_dim)):
        module = getattr(trainer.model, side)
        for m in module.modules():
            if isinstance(m, Attention):
                assert (m.tp is not None) == (n_model > 1 and jmod.heads % n_model == 0), (side, m.attn.method)
            elif isinstance(m, FeedForward):
                assert (m.tp is not None) == (n_model > 1 and hidden % n_model == 0), side
        rings = (n_seq > 1 and jmod.attn.ring and jmod.attn.softmax != "adjustable" and views % n_seq == 0)
        assert getattr(trainer.model, f"ring_{side}") == rings, side
    full = dict(whole.named_parameters())
    split = {f"{prefix}.{name}" for prefix, m in trainer.model.named_modules()
             if isinstance(m, (Attention, FeedForward)) and m.tp is not None for name, _ in m.named_parameters()}
    assert set(trainer.tp_specs) <= split
    for name, p in trainer.model.named_parameters():
        if name in trainer.tp_specs:
            dim = trainer.tp_specs[name][0]
            assert p.shape[dim] * n_model == full[name].shape[dim], name
        else:
            assert p.shape == full[name].shape, name


def test_tp_split_keeps_each_section_and_inverts():
    """shard_tensor takes each rank's heads from every section of to_qkv
    (rank 0 gets q, k and v heads, not three q heads), and unshard_tensor
    inverts it."""
    full = torch.arange(3 * 4 * 2, dtype=torch.float32).reshape(12, 2)  # 3 sections of 2 heads x 2 rows
    blocks = [tp.shard_tensor(full, (0, 3), r, 2) for r in range(2)]
    assert blocks[0][:, 0].tolist() == [0, 2, 8, 10, 16, 18]
    assert torch.equal(tp.unshard_tensor(blocks, (0, 3)), full)
    col = torch.arange(12.0).reshape(2, 6)
    assert torch.equal(tp.unshard_tensor([tp.shard_tensor(col, (1, 1), r, 3) for r in range(3)], (1, 1)), col)


def test_zero_partition_balances_and_covers():
    from gta_tpu_torch.parallel.zero import partition

    owner = partition([10, 1, 7, 3, 3], 2)
    assert owner == [0, 1, 1, 1, 0] and sorted(set(owner)) == [0, 1]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
