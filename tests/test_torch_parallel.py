"""Tensor parallel, the view-sharded GTA ring and ZeRO-1 in the port: gloo
processes on the CPU against one process.

One module fixture starts two worlds side by side, each this file run as a
script in every rank (a free localhost port each, each `communicate` under
its own timeout), and waits for both:
  - two ranks: one train step each under --n-model 2 (the shrunk flagship,
    with dropout 0 and with the flagship's dropout 0.01; the SRT baseline
    through flash_core's plain version; msn_so3 in bf16), under --n-seq 2
    (dropout 0 and 0.01) and under ZeRO-1 over two data ranks; the ring GTA
    attention on numpy inputs (self- and cross-attention, the block-diagonal
    and the sliced transforms, 2 views a rank); then the train CLI under
    --n-seq 2 --accum 2;
  - four ranks: TP + ZeRO-1 + --accum 2 over 2 data x 2 model ranks, its
    checkpoint, a one-process checkpoint restored under that layout and
    saved again; the ring attention at one view a rank; then the train CLI
    under --n-model 2 --zero --accum 2.
Rank 0 of each world saves what the tests hold against the same calls in
one process here: the loss (rtol 1e-5), every parameter's gradient by name
(relative L2 <= 1e-5), the updated weights (atol 3e-5, the bound of
tests/test_ring.py:224). The shrunk flagship is that of
tests/test_torch_distributed.py (2 heads of 64, one attention block a side,
32x48 inputs, 48 target rays), lr_warmup 0. The workers import no JAX; the
ring attention's reference is the JAX package's dense gta_attention,
computed here.
"""

import contextlib
import dataclasses
import functools
import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from gta_tpu_torch.config import FDims, GTAArgs, load_config
from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
from gta_tpu_torch.parallel import dist as pdist
from gta_tpu_torch.parallel import tp
from gta_tpu_torch.train.checkpoint import Checkpointer
from gta_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "runs", "clevrtr", "GTA", "gta", "config.yaml")
SRT = os.path.join(ROOT, "runs", "clevrtr", "otherPEs", "srt", "config.yaml")
MSN_SO3 = os.path.join(ROOT, "runs", "msn", "GTA", "gta_so3", "config.yaml")
B = 4  # the global batch
TIMEOUT = 150  # seconds, per communicate
GRAD_RTOL, WEIGHT_ATOL = 1e-5, 3e-5
BF16_RULE = 1.5  # chip_smoke.py's bf16 rule
# the ring attention's inputs (tests/test_ring.py's): B=2, H=2, 4 views of 6
# tokens, 2 target views of 5 rays; the sliced transforms (t2 in the mix)
# and the block-diagonal ones
RB, RH, NV, TPV, NQ, TQ = 2, 2, 4, 6, 2, 5
RING_ARGS = {"sliced": GTAArgs(f_dims=FDims(triv=2, se3=8, so3=8, so2=8, t2=6), so2=2, so3=2),
             "blockdiag": GTAArgs(f_dims=FDims(triv=8, se3=8, so3=8, so2=8), so2=2, so3=2)}
RING_FWD_TOL, RING_GRAD_TOL = 1e-6, 1e-5  # relative L2 from the dense fp32 reference: fp32 round-off


def shrink(path, heads=2, dropout=0.0, mixed_prec=None, **training):
    """A config at the tests' width: `heads` heads of its head width, one
    attention block a side, 32x48 inputs (32x32 for msn), 48 target rays,
    lr_warmup 0."""
    cfg = load_config(path)
    m = cfg.model
    head = m.encoder.attdim // m.encoder.heads
    msn = m.encoder.heads == 8
    data = dataclasses.replace(cfg.data, dataset="synthetic", height=32, width=32 if msn else 48, downsample=0,
                               num_points=48)
    enc = dataclasses.replace(m.encoder, dim=64, attdim=heads * head, heads=heads, num_att_blocks=1, dropout=dropout)
    dec = dataclasses.replace(m.decoder, z_dim=heads * head, heads=heads, rmlp_dim=64, num_att_blocks=1,
                              dropout=dropout)
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
}
CASES4 = {"tp_zero_accum2": (lambda: shrink(FLAGSHIP, grad_accum=2), 2, 1, True)}


def items(cfg, rows):
    ds = SyntheticScenes(cfg.data, "train")
    return [ds[i] for i in rows]


def write_yaml(out_dir, **training):
    """The shrunk flagship as a YAML (the train CLI rewrites its 64x96
    frames to 32x48 synthetic scenes), batch B, print_every 1, no periodic
    checkpoint, evaluation or render, lr_warmup 0."""
    with open(FLAGSHIP) as f:
        raw = yaml.safe_load(f)
    raw["data"]["num_points"] = 48
    raw["data"]["kwargs"].update(height=64, width=96)
    enc, dec = raw["model"]["args"]["encoder_kwargs"], raw["model"]["args"]["decoder_kwargs"]
    enc.update(dim=64, attdim=128, heads=2, num_att_blocks=1)
    dec.update(z_dim=128, heads=2, rmlp_dim=64, num_att_blocks=1)
    raw["training"].update({"batch_size": B, "print_every": 1, "checkpoint_every": 0, "backup_every": 0,
                            "validate_every": 0, "visualize_every": 0, "lr_warmup": 0, **training})
    path = os.path.join(str(out_dir), "config.yaml")
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


def step_case(cfg, n_model, n_seq, zero):
    """One train step under the layout, on this data rank's rows of the
    global batch; the whole state after it and the kernels' backward
    entries it called."""
    mesh = pdist.init_mesh(n_model, n_seq)
    trainer = Trainer(cfg, device="cpu", zero=zero, mesh=mesh)
    d, D = mesh.data.index, mesh.data.size
    with counted_backwards({}) as calls:
        m = trainer.train_step(collate(items(cfg, range(d * B // D, (d + 1) * B // D))))
    return {"loss": float(m["loss"]), "mse": float(m["mse"]), "grad_norm": float(m["grad_norm"]),
            "grads": whole_grads(trainer), "state": trainer.state_dict(), "backwards": calls}, trainer


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
    for name, (make, n_model, n_seq, zero) in cases.items():
        out[name], trainer = step_case(make(), n_model, n_seq, zero)
    if world == 4:
        # the TP + ZeRO-1 trainer's checkpoint, then a one-process checkpoint
        # restored under that layout and saved again
        Checkpointer(os.path.join(work_dir, "sharded")).save("latest", trainer, {"it": 0})
        restored = Trainer(CASES4["tp_zero_accum2"][0](), device="cpu", zero=True, mesh=trainer.mesh)
        Checkpointer(os.path.join(work_dir, "single")).restore("latest", restored)
        Checkpointer(os.path.join(work_dir, "resaved")).save("latest", restored)
    out["ring_attention"] = ring_case(world)
    printed = io.StringIO()
    cli = ["--n-seq", "2", "--accum", "2"] if world == 2 else ["--n-model", "2", "--zero", "--accum", "2"]
    with contextlib.redirect_stdout(printed):
        t_train.main([os.path.join(work_dir, "config.yaml"), "--synthetic", "--device", "cpu", "--outdir",
                      os.path.join(work_dir, "cli"), "--exit-after", "1", *cli])
    out["cli"] = printed.getvalue()
    if rank == 0:
        torch.save(out, os.path.join(out_dir, f"world{world}.pt"))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: what its rank 0 saved} and {world: its work directory}."""
    out = tmp_path_factory.mktemp("parallel")
    work = {w: tmp_path_factory.mktemp(f"world{w}") for w in (2, 4)}
    for w in work.values():
        write_yaml(w)
    # the one-process checkpoint the four ranks restore
    cfg = CASES4["tp_zero_accum2"][0]()
    single = Trainer(cfg, device="cpu")
    single.train_step(collate(items(cfg, range(B))))
    Checkpointer(os.path.join(work[4], "single")).save("latest", single)
    procs = {}
    for world, wd in work.items():
        env = {**os.environ, "PYTHONPATH": os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]),
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()), "WORLD_SIZE": str(world),
               "OMP_NUM_THREADS": "1"}
        procs[world] = [subprocess.Popen([sys.executable, __file__, str(world), str(out), str(wd)], cwd=ROOT,
                                         env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                        for r in range(world)]
    logs = {}
    try:
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
    return {w: torch.load(os.path.join(out, f"world{w}.pt"), weights_only=False) for w in work}, work


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


def hold_step(got, cfg):
    """A parallel step's loss, gradients and updated weights against the
    one-process step's."""
    want, grads, state = one_process(cfg)
    for k in ("loss", "mse", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert got["grads"].keys() == grads.keys()
    for name, g in grads.items():
        assert got["grads"][name].shape == g.shape, name
        err = rel_l2(got["grads"][name], g)
        assert err <= GRAD_RTOL or not g.abs().max() > 0, (name, err)
    for name, w in state["model"].items():
        np.testing.assert_allclose(got["state"]["model"][name], w, atol=WEIGHT_ATOL, rtol=0, err_msg=name)
    return state


@pytest.mark.parametrize("name", [n for n in CASES2 if n != "tp_msn_bf16"] + list(CASES4))
def test_parallel_step_matches_one_process(runs, name):
    """TP (flagship with and without dropout, SRT through flash_core's plain
    version), the ring (with and without dropout: every rank draws the
    whole activation's mask and keeps its block), ZeRO-1, and TP + ZeRO-1 +
    accum 2: loss, every gradient by name and the updated weights against
    one process; the moments gathered in the state equal one process's to
    the same bounds."""
    res, _ = runs
    got = res[2 if name in CASES2 else 4][name]
    make = (CASES2 if name in CASES2 else CASES4)[name][0]
    state = hold_step(got, make())
    opt_got, opt_want = got["state"]["optimizer"], state["optimizer"]
    assert opt_got["param_groups"] == opt_want["param_groups"]
    assert opt_got["state"].keys() == opt_want["state"].keys()
    for i, st in opt_want["state"].items():
        assert float(opt_got["state"][i]["step"]) == float(st["step"]) == 1.0
        for key in ("exp_avg", "exp_avg_sq"):
            assert opt_got["state"][i][key].shape == st[key].shape
            err = rel_l2(opt_got["state"][i][key], st[key])
            assert err <= 2 * GRAD_RTOL or not st[key].abs().max() > 0, (i, key, err)


def test_the_ring_backward_calls_no_kernel_backward(runs):
    """The ring's backward is its own autograd Function: under --n-seq 2 a
    flagship step reaches neither flash_core_bwd nor gta_fused_bwd (their
    instances assume every key of a row), under --n-model 2 each layer
    calls gta_fused_bwd once (SRT: flash_core_bwd)."""
    res, _ = runs
    for name in ("ring", "ring_dropout"):
        assert res[2][name]["backwards"] == {}, name
    assert res[2]["tp"]["backwards"] == {"gta_fused_bwd": 2}
    assert res[2]["tp_srt"]["backwards"] == {"flash_core_bwd": 2}


def test_tp_bf16_sits_within_the_bf16_rule(runs):
    """msn_so3 (2 heads of 96, bf16) under --n-model 2: its gradient's
    relative L2 from the one-process fp32 step at most 1.5x that of the
    one-process bf16 step (its partial products summed in fp32, rounded
    once). Two bf16 steps whose sums run in different orders differ by
    about bf16's own error (a rounding that flips moves what follows), so
    the TP step is held to fp32, as chip_smoke.py holds the card's bf16."""
    res, _ = runs
    got = res[2]["tp_msn_bf16"]
    _, g16, _ = one_process(shrink(MSN_SO3, mixed_prec=True))
    _, g32, _ = one_process(shrink(MSN_SO3, mixed_prec=False))
    flat = lambda g: np.concatenate([g[n].numpy().ravel() for n in sorted(g32)])  # noqa: E731
    tp_err, own_err = rel_l2(flat(got["grads"]), flat(g32)), rel_l2(flat(g16), flat(g32))
    assert tp_err <= BF16_RULE * own_err, (tp_err, own_err)


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
    res, _ = runs
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

    res, work = runs
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
    res, work = runs
    printed = res[world]["cli"]
    assert f"Data parallel: backend gloo, world size {world}, rank 0" in printed
    mesh = "data 1 x seq 2 x model 1" if world == 2 else "data 2 x seq 1 x model 2"
    assert f"Mesh: {mesh}" in printed and f"ZeRO-1 {'on' if world == 4 else 'off'}" in printed
    assert "it=1, loss=" in printed and "Iteration limit reached. Exiting." in printed
    cfg = load_config(os.path.join(work[world], "config.yaml"))
    one = Trainer(cfg, device="cpu")
    Checkpointer(os.path.join(work[world], "cli")).restore("latest", one)
    assert one.step == 2 and all(torch.isfinite(p).all() for p in one.model.parameters())


@pytest.mark.parametrize("flags, message", [
    (["--n-model", "3"], "--n-model 3 does not divide the encoder's attention heads (2)"),
    (["--n-seq", "3"], "--n-seq 3 does not divide the 2 input views"),
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


def test_eager_methods_raise_under_tensor_parallel():
    """A layer JAX computes with XLA (here gbt's Plücker bias) is not split:
    building its trainer under --n-model 2 names ROADMAP item 9e."""
    cfg = shrink(os.path.join(ROOT, "runs", "clevrtr", "otherPEs", "gbt", "config.yaml"))
    mesh = pdist.Mesh(pdist.Axis(), pdist.Axis(), pdist.Axis(2, 0, (0, 1)))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 9e"):
        Trainer(cfg, device="cpu", mesh=mesh)


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
