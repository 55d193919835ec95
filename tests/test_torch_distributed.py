"""Data parallel in the port: two gloo processes on the CPU against one.

`_run_ranks` starts this file as a script in two processes (RANK 0 and 1
of WORLD_SIZE 2, a free localhost port, each `communicate` under its own
timeout); each joins the group through `parallel.dist.init_from_env("cpu")`
and runs `_worker`: a train step, a step at grad_accum 2, `evaluate`, the
sorted-key mean, a stop flag raised on one rank, a DiT step and the train
CLI with a SIGTERM on rank 1, each rank on rows [r*b/2, (r+1)*b/2) of one
global batch made here (not through the loader's shards, whose first
global batch differs). The tests hold what the ranks saved against the
same calls in one process on the whole batch. The shrunk flagship (2 heads
of 64, one attention block a side, 32x48 inputs, 48 target rays), dropout
0, lr_warmup 0 (the first step moves the weights). Imports no JAX, so the
workers start quickly.
"""

import contextlib
import dataclasses
import io
import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from gta_tpu_torch.config import load_config
from gta_tpu_torch.data.images import SyntheticImages, collate_images
from gta_tpu_torch.data.loader import Loader
from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
from gta_tpu_torch.parallel import dist as pdist
from gta_tpu_torch.train.dit_trainer import DiTTrainer, dit_config_from_dict
from gta_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "runs", "clevrtr", "GTA", "gta", "config.yaml")
B = 4  # the global batch
WORLD = 2
TIMEOUT = 120  # seconds, per communicate


def tiny_cfg(**training):
    """The flagship at the tests' width, dropout 0 and lr_warmup 0."""
    cfg = load_config(FLAGSHIP)
    m = cfg.model
    enc = dataclasses.replace(m.encoder, dim=64, attdim=128, heads=2, num_att_blocks=1, dropout=0.0)
    dec = dataclasses.replace(m.decoder, z_dim=128, heads=2, rmlp_dim=64, num_att_blocks=1, dropout=0.0)
    data = dataclasses.replace(cfg.data, dataset="synthetic", height=32, width=48, downsample=0, num_points=48)
    return dataclasses.replace(cfg, data=data, model=dataclasses.replace(m, encoder=enc, decoder=dec),
                               training=dataclasses.replace(cfg.training, lr_warmup=0, **training))


def tiny_yaml(tmp_path, **training):
    """The flagship YAML at the tests' width (64x96 frames, 2 heads, one
    attention block a side, batch 2), with `training` settings over
    print_every 1, validate_every 2, checkpoint_every 2, backup_every 3,
    lr_warmup 1."""
    with open(FLAGSHIP) as f:
        raw = yaml.safe_load(f)
    raw["data"]["num_points"] = 48
    raw["data"]["kwargs"].update(height=64, width=96)
    enc, dec = raw["model"]["args"]["encoder_kwargs"], raw["model"]["args"]["decoder_kwargs"]
    enc.update(dim=64, attdim=128, heads=2, num_att_blocks=1)
    dec.update(z_dim=128, heads=2, rmlp_dim=64, num_att_blocks=1)
    raw["training"].update({"batch_size": 2, "print_every": 1, "checkpoint_every": 2, "backup_every": 3,
                            "validate_every": 2, "lr_warmup": 1, **training})
    path = os.path.join(str(tmp_path), "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def tiny_dit():
    """tests/test_torch_dit.py's tiny GTA DiT, lr_warmup 0."""
    gta = {"method": {"name": "gta", "args": {"f_dims": {"triv": 8, "so2": 8}, "so2": 2}}}
    return dit_config_from_dict({
        "data": {"dataset": "imagenet", "path": None, "num_images": 64},
        "model": {"model_type": "dit", "args": {"dit_kwargs": {
            "input_size": 8, "patch_size": 2, "in_channels": 3, "hidden_size": 32, "depth": 2, "heads": 2,
            "num_classes": 4, "timesteps": 50, "attn_args": gta}}},
        "training": {"batch_size": B, "lr": 1e-3, "lr_warmup": 0},
    })


def _items(cfg, mode, rows):
    ds = SyntheticScenes(cfg.data, mode)
    return [ds[i] for i in rows]


def _dit_batch(rows):
    ds = SyntheticImages(8, 4, "train", 16)
    return collate_images([ds[i] for i in rows])


def _params(trainer):
    return {n: p.detach().numpy().copy() for n, p in trainer.model.named_parameters()}


def _step(trainer, batch):
    m = trainer.train_step(batch)
    return {"loss": float(m["loss"]), "mse": float(m["mse"]), "grad_norm": float(m["grad_norm"]),
            "params": _params(trainer), "grads": {n: p.grad.numpy().copy() for n, p in trainer.model.named_parameters()}}


def _worker(out_dir, cli_dir):
    """One rank's side of every check; saves `<out_dir>/rank<r>.pt`."""
    from gta_tpu_torch.train import __main__ as t_train

    torch.set_num_threads(2)
    assert pdist.init_from_env("cpu") == "cpu" and pdist.world() == WORLD
    r = pdist.rank()
    rows = range(r * B // WORLD, (r + 1) * B // WORLD)
    out = {"describe": pdist.describe()}
    cfg = tiny_cfg()
    batch = collate(_items(cfg, "train", rows))
    out["step"] = _step(Trainer(cfg, device="cpu"), batch)
    out["accum2"] = _step(Trainer(tiny_cfg(grad_accum=2), device="cpu"), batch)

    trainer = Trainer(cfg, device="cpu")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out["evaluate"] = trainer.evaluate([collate(_items(cfg, "val", [i])) for i in rows])
    out["evaluate_printed"] = printed.getvalue()
    local = {"psnr": r + 1.0, "mse": 10.0 * (r + 1)} if r == 0 else {"mse": 10.0 * (r + 1), "psnr": r + 1.0}
    out["mean_over_ranks"] = list(pdist.mean_over_ranks(local, "cpu").items())

    # rank 1 asks to stop at its second step; every rank must see it there
    out["stops"] = [bool(trainer.train_step(batch, stop=r == 1 and n == 1)["stop"]) for n in range(3)]

    dit = DiTTrainer(tiny_dit(), device="cpu")
    dit.train_step(_dit_batch(rows))
    out["dit_params"] = _params(dit)

    # the train CLI: rank 1 receives SIGTERM after its first step; torch.save
    # calls are counted per rank
    saves, steps = [], []
    save, train_step = torch.save, Trainer.train_step

    def counting_save(obj, path, *a, **k):
        saves.append(os.path.relpath(str(path), cli_dir))
        return save(obj, path, *a, **k)

    def signalled_step(self, b, stop=False):
        steps.append(stop)
        m = train_step(self, b, stop)
        if r == 1 and len(steps) == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return m

    torch.save, Trainer.train_step = counting_save, signalled_step
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            t_train.main([os.path.join(cli_dir, "config.yaml"), "--synthetic", "--device", "cpu", "--outdir",
                          cli_dir, "--exit-after", "5", "--evalnow", "--max-eval", "4"])
    finally:
        torch.save, Trainer.train_step = save, train_step
    out["cli"] = {"saves": saves, "steps": steps, "printed": printed.getvalue()}
    save(out, os.path.join(out_dir, f"rank{r}.pt"))
    pdist.destroy()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each of the two gloo ranks saved ({rank: results}), and the
    train CLI's output directory."""
    out = tmp_path_factory.mktemp("ranks")
    cli_dir = tmp_path_factory.mktemp("cli")
    tiny_yaml(cli_dir, batch_size=B, checkpoint_every=0, backup_every=0, validate_every=0)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]),
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()), "WORLD_SIZE": str(WORLD)}
    procs = [subprocess.Popen([sys.executable, __file__, str(out), str(cli_dir)], cwd=ROOT,
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return {r: torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(WORLD)}, cli_dir


def _close(got, want, rtol=1e-5, atol=1e-9, what=""):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("key, accum", [("step", 1), ("accum2", 2)])
def test_two_ranks_take_the_single_process_step(ranks, key, accum):
    """loss, mse and grad_norm (global means), every averaged gradient and
    every parameter after one step, with and without grad_accum 2, against
    one process on the whole batch, at rtol 1e-5 (atol 1e-9 for the
    elements near 0; a gradient also 1e-5 of its tensor's largest element:
    the conv stem's sums cancel); the two ranks' parameters bit for bit
    equal. AdamW
    moves a weight by lr * m / (sqrt(v) + 1e-8): where a gradient sits near
    that eps its step follows the sum's rounding, so parameters may also
    differ by a thousandth of lr (at accum 2 a weight of 5.5e-4 moved
    3.6e-8 apart: the ranks' microbatches are rows {0}, {1} and {2}, {3},
    the single process's {0, 2} and {1, 3})."""
    res, _ = ranks
    cfg = tiny_cfg(grad_accum=accum)
    want = _step(Trainer(cfg, device="cpu"), collate(_items(cfg, "train", range(B))))
    for r in range(WORLD):
        got = res[r][key]
        for k in ("loss", "mse", "grad_norm"):
            _close(got[k], want[k], what=f"rank {r} {k}")
        for name, g in want["grads"].items():  # 1e-5 of the tensor's largest (sums that cancel)
            _close(got["grads"][name], g, atol=1e-5 * np.abs(g).max(), what=f"rank {r} d{name}")
        for name, p in want["params"].items():
            _close(got["params"][name], p, atol=1e-3 * cfg.training.lr, what=f"rank {r} {name}")
    assert all(np.array_equal(res[0][key]["params"][n], res[1][key]["params"][n]) for n in want["params"])
    assert res[0]["describe"] == "Data parallel: backend gloo, world size 2, rank 0"


def test_evaluate_reduces_over_ranks(ranks):
    """evaluate's dict against one process on all 4 val scenes; the unique
    scene count over the gathered ids (4, not a rank's 2); the per-rank
    means averaged by sorted key whatever each rank's key order."""
    res, _ = ranks
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        want = Trainer(tiny_cfg(), device="cpu").evaluate([collate(_items(tiny_cfg(), "val", [i])) for i in range(B)])
    assert printed.getvalue() == "Evaluated 4 unique scenes.\n"
    for r in range(WORLD):
        assert list(res[r]["evaluate"]) == sorted(want)
        for k, v in want.items():
            _close(res[r]["evaluate"][k], v, what=f"rank {r} {k}")
        assert res[r]["evaluate_printed"] == "Evaluated 4 unique scenes.\n"
        assert res[r]["mean_over_ranks"] == [("mse", 15.0), ("psnr", 1.5)]


def test_a_stop_flag_on_one_rank_stops_every_rank(ranks):
    res, _ = ranks
    assert res[0]["stops"] == res[1]["stops"] == [False, True, False]


def test_dit_ranks_average_their_own_draws(ranks, monkeypatch):
    """Both ranks' DiT parameters after a step are one, and equal one
    process that averages the two shards' gradients, each drawn with its
    rank's generator (pdist.step_seed(seed, 0, r))."""
    res, _ = ranks
    trainer = DiTTrainer(tiny_dit(), device="cpu")
    grads = []
    for r in range(WORLD):
        monkeypatch.setattr(pdist, "rank", lambda r=r: r)
        _, _, g = trainer.loss_and_grads(_dit_batch(range(r * B // WORLD, (r + 1) * B // WORLD)))
        grads.append([x.clone() for x in g])
    assert pdist.step_seed(0, 0, 0) != pdist.step_seed(0, 0, 1)
    for p, g0, g1 in zip(trainer.model.parameters(), *grads):
        p.grad = (g0 + g1) / WORLD
    trainer.optimizer.step()
    want = _params(trainer)
    for r in range(WORLD):
        for name, p in want.items():
            _close(res[r]["dit_params"][name], p, rtol=1e-6, what=f"rank {r} {name}")
    assert all(np.array_equal(res[0]["dit_params"][n], res[1]["dit_params"][n]) for n in want)


def test_train_cli_rank_zero_writes_and_both_stop_together(ranks):
    """The train CLI under two ranks: SIGTERM on rank 1 after step 0 stops
    both after step 1 (the flag rides the gradient all_reduce); only rank 0
    prints, writes metrics.jsonl (one line per event) and saves (best at
    --evalnow, then latest)."""
    res, cli_dir = ranks
    for r in range(WORLD):
        assert res[r]["cli"]["steps"] == [False, r == 1], r
    assert res[0]["cli"]["saves"] == [os.path.join("ckpts", n, "state.pt.tmp") for n in ("best", "latest")]
    assert res[1]["cli"]["saves"] == []
    printed = res[0]["cli"]["printed"]
    assert "Data parallel: backend gloo, world size 2, rank 0" in printed
    assert "it=1, loss=" in printed and "Preemption checkpoint saved. Exiting." in printed
    assert "it=" not in res[1]["cli"]["printed"]
    with open(os.path.join(cli_dir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    assert [(d["kind"], d["it"]) for d in logged] == [("eval", 0), ("train", 0), ("train", 1)]
    with open(os.path.join(cli_dir, "ckpts", "latest", "scalars.json")) as f:
        assert json.load(f)["it"] == 1
    assert torch.load(os.path.join(cli_dir, "ckpts", "latest", "state.pt"), weights_only=False)["step"] == 2


def test_loader_shards_are_disjoint_and_even():
    ds = SyntheticScenes(tiny_cfg().data, "train", max_len=11)
    for epoch in (0, 1):
        shards = []
        for r in range(WORLD):
            loader = Loader(ds, 2, seed=3, num_workers=1, shard_index=r, shard_count=WORLD)
            loader.set_epoch(epoch)
            shards.append([int(i) for b in loader for i in b.sceneid])
        assert len(shards[0]) == len(shards[1]) == 4 and not set(shards[0]) & set(shards[1])


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
