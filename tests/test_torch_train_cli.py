"""The port's train CLI (`python -m gta_tpu_torch.train`): the options of
the JAX package's train.py and their runtime behaviour, on the CPU at the
tests' width (tests/test_torch_distributed.tiny_yaml: 64x96 frames, 2
heads, one attention block a side, batch 2)."""

import json
import os
import re
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from gta_tpu_torch.data import registry
from gta_tpu_torch.train import __main__ as t_train
from gta_tpu_torch.train.checkpoint import Checkpointer
from gta_tpu_torch.train.trainer import Trainer
from tests.test_torch_distributed import ROOT, tiny_yaml

TIMEOUT = 120  # seconds, per subprocess


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny steps, many of them (the speed test takes 101): intra-op
    threads only contend with the parallel test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(cfg, out, *extra):
    t_train.main([cfg, "--synthetic", "--device", "cpu", "--outdir", str(out), *extra])


@pytest.fixture
def cfg(tmp_path):
    return tiny_yaml(tmp_path, checkpoint_every=0, backup_every=0, validate_every=0)


def test_options_contain_train_py_options():
    """Every option of train.py's parser (read from its --help; it imports
    JAX only after parsing), and --device besides."""
    proc = subprocess.run([sys.executable, "train.py", "--help"], cwd=ROOT, capture_output=True, text=True,
                          timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    theirs = set(re.findall(r"(?<![\w-])(--?[A-Za-z][\w-]*)", proc.stdout.split("options:", 1)[1]))
    ours = set(t_train.build_parser()._option_string_actions)
    assert len(theirs) > 20 and theirs <= ours, theirs - ours
    assert ours - theirs == {"--device"}


def test_accum_below_one_is_a_parser_error(cfg, capsys):
    with pytest.raises(SystemExit) as e:
        t_train.main([cfg, "--accum", "0"])
    assert e.value.code == 2 and "--accum must be >= 1, got 0" in capsys.readouterr().err


@pytest.mark.parametrize("flag, item", [(["--n-model", "2"], "9c"), (["--n-seq", "2"], "9c"), (["--zero"], "9c"),
                                        (["--device-data"], "6")])
def test_unported_parallelism_and_device_data_raise(cfg, tmp_path, flag, item):
    with pytest.raises(NotImplementedError, match=rf"{flag[0]} .*\(ROADMAP queue 1 item {item}\)"):
        _run(cfg, tmp_path / "run", *flag)


def test_test_split_and_full_scale_reach_the_registry(cfg, tmp_path, monkeypatch):
    calls = []

    def get_dataset(mode, data, full_scale=False, max_len=None, seed=0):
        calls.append((mode, full_scale, max_len))
        return real(mode, data, full_scale=full_scale, max_len=max_len, seed=seed)

    real = registry.get_dataset
    monkeypatch.setattr(registry, "get_dataset", get_dataset)
    _run(cfg, tmp_path / "a", "--exit-after", "0", "--max-eval", "3")
    _run(cfg, tmp_path / "b", "--exit-after", "0", "--max-eval", "3", "--test", "--full-scale")
    assert calls == [("train", False, None), ("val", False, 3), ("train", False, None), ("test", True, 3)]


def test_print_model_lists_every_state_dict_key(cfg, tmp_path, capsys):
    _run(cfg, tmp_path / "run", "--exit-after", "0", "--print-model")
    lines = capsys.readouterr().out.splitlines()
    from gta_tpu_torch.config import load_config

    want = Trainer(load_config(cfg), device="cpu").model.state_dict()
    for key, value in want.items():
        assert f"{key} {tuple(value.shape)}" in lines, key


def test_debug_nans_raises_on_a_planted_nan(cfg, tmp_path, monkeypatch, capsys):
    """A NaN planted in the loss: --debug-nans raises FloatingPointError
    (anomaly mode finds it in the backward) and leaves anomaly mode off;
    without the flag the run takes its step."""
    loss_fn = Trainer._loss_fn
    monkeypatch.setattr(Trainer, "_loss_fn", lambda self, b: (lambda l, m: (l * float("nan"), m))(*loss_fn(self, b)))
    _run(cfg, tmp_path / "a", "--exit-after", "0")
    assert "it=0, loss=nan" in capsys.readouterr().out
    with pytest.raises(FloatingPointError, match="--debug-nans at it=0"):
        _run(cfg, tmp_path / "b", "--exit-after", "0", "--debug-nans")
    assert not torch.is_anomaly_enabled()


def test_speed_test_writes_the_chained_mean(cfg, tmp_path, capsys):
    """--speed_test 2 halves the batch (1 item) and times 100 steps chained
    between two host syncs, after one untimed step; it returns after step
    100, before that step's print (as train.py)."""
    out = tmp_path / "run"
    _run(cfg, out, "--speed_test", "2")
    printed = capsys.readouterr().out
    ms = np.load(out / "time.npy")
    assert ms.shape == (1,) and ms[0] > 0 and f"chained mean step time: {ms[0]:.2f} ms" in printed
    assert "it=99, loss=" in printed and "it=100" not in printed


def test_profile_writes_a_trace(cfg, tmp_path, capsys):
    out = tmp_path / "run"
    _run(cfg, out, "--exit-after", "3", "--profile", "2")
    assert f"Profiler trace written to {out}/trace" in capsys.readouterr().out
    with open(out / "trace" / "rank0.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("train_step" in e.get("name", "") or "backward" in e.get("name", "").lower() for e in events)


def test_wandb_and_rtpt_print_their_guards(cfg, tmp_path, capsys):
    _run(cfg, tmp_path / "run", "--exit-after", "0", "--wandb", "--rtpt", "XY")
    printed = capsys.readouterr().out
    assert "rtpt unavailable (No module named 'rtpt'); continuing without" in printed
    assert "wandb unavailable (No module named 'wandb'); continuing without" in printed
    assert "it=0, loss=" in printed


def test_sigterm_saves_latest_and_the_rerun_resumes(cfg, tmp_path, capsys):
    """SIGTERM once step 1 has printed: the run finishes its step, saves
    `latest`, exits 0; a rerun resumes at the saved it + 1, and
    metrics.jsonl holds both runs in scripts/plot_metrics.py's schema
    (which plots it)."""
    out = tmp_path / "run"
    proc = subprocess.Popen([sys.executable, "-m", "gta_tpu_torch.train", cfg, "--synthetic", "--device", "cpu",
                             "--outdir", str(out), "--exit-after", "100000", "--evalnow", "--max-eval", "2"],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, "PYTHONUNBUFFERED": "1", "OMP_NUM_THREADS": "1"})
    watchdog = threading.Timer(TIMEOUT, proc.kill)
    watchdog.start()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if "it=1, loss=" in line:
                proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=TIMEOUT)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
    log = "".join(lines)
    assert rc == 0, log
    assert "Preemption checkpoint saved. Exiting." in log
    stopped = max(int(m) for m in re.findall(r"it=(\d+), loss=", log))
    with open(out / "ckpts" / "latest" / "scalars.json") as f:
        assert json.load(f)["it"] == stopped
    assert Checkpointer(str(out)).exists("latest")

    _run(cfg, out, "--exit-after", str(stopped + 2))
    printed = capsys.readouterr().out
    assert f"Resumed from checkpoint at it={stopped + 1}" in printed and "Iteration limit reached" in printed
    with open(out / "metrics.jsonl") as f:
        logged = [json.loads(line) for line in f]
    assert [(d["kind"], d["it"]) for d in logged] == (
        [("eval", 0)] + [("train", i) for i in range(stopped + 3)])
    for d in logged:
        assert sorted(d) == (["it", "kind", "loss", "lr", "t"] if d["kind"] == "train" else
                             ["it", "kind", "mse", "psnr", "t"])
    from scripts import plot_metrics

    argv = sys.argv
    sys.argv = ["plot_metrics", str(out)]
    try:
        plot_metrics.main()
    finally:
        sys.argv = argv
    assert (out / "curves.png").stat().st_size > 0
