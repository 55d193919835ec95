"""The comparison that decides `correct`, driven end to end at a shrunk
size on the CPU (portbench/tiny.py): the reference against the port's
fp32 path, a whole run, the fp8 control and the faults a cell can have. The card test runs the control at a cell's own
size."""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path

import pytest
import torch

from portbench import calibrate, check, run

ROOT = Path(__file__).resolve().parents[1]
CELLS = ["msn_gta_so3.train", "msn_srt.train", "msn_gta_so3.serve"]
SEED = 2**31 + 12345


# Shrunk copies of a cell's config and traffic: every size cut so that a
# whole run and its comparison take seconds on a CPU; the options
# (attention method, GTA representations, embeddings, dropout) kept.
def tiny_config(config: dict) -> dict:
    c = copy.deepcopy(config)
    s, rc = c["sizes"], c["run_config"]
    heads, head = 2, s["decoder"]["dim_head"]
    s["data"].update(height=32, width=32, num_input_views=2, num_target_views=2, num_points=32, tokens_per_view=16)
    s["encoder"].update(dim=64, attdim=heads * head, num_att_blocks=2, heads=heads)
    s["decoder"].update(dim=32, num_att_blocks=1, heads=heads, mlp_dim=64, z_dim=heads * head, rmlp_dim=64)
    rc["data"]["num_points"] = 32
    rc["data"]["kwargs"].update(num_input_views=2, num_target_views=2, height=32, width=32)
    rc["model"]["args"]["encoder_kwargs"].update(dim=64, attdim=heads * head, num_att_blocks=2, heads=heads)
    rc["model"]["args"]["decoder_kwargs"].update(dim=32, num_att_blocks=1, heads=heads, dim_head=head, mlp_dim=64,
                                                z_dim=heads * head, rmlp_dim=64)
    return c


def tiny_traffic(traffic: dict) -> dict:
    t = dict(traffic)
    if t["entry"] == "train_step":
        t.update(batch_size=2, pool=4, trace_steps=2)
    else:
        t.update(scenes_per_call=2, pool=4, chunk=512, sample_calls=1, trace_steps=2)
    return t


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny(bench, workload, fp32=False):
    _, config, traffic = run.cell_files(bench, workload)
    config, traffic = tiny_config(config), tiny_traffic(traffic)
    if fp32:
        config["run_config"]["training"]["mixed_prec"] = False
    return config, traffic


def program_numbers(config, traffic, seed, fault="none", precision="fp32"):
    weights, readings = calibrate.program_run(config, traffic, seed, "cpu", fault)
    ref = calibrate.reference_side(config, traffic, weights, readings, seed, "fp32")
    if precision != "fp32":  # the control in the program's place
        return calibrate.compare(traffic, calibrate.reference_side(config, traffic, weights, readings, seed, precision),
                                 ref)
    prog = readings if traffic["entry"] == "train_step" else [f for f, _, _ in readings["frames"]]
    return calibrate.compare(traffic, prog, ref)


@pytest.mark.parametrize("workload", CELLS)
def test_reference_matches_the_ports_fp32_path(bench, workload):
    """The port computing in fp32 (its plain kernels on the CPU) and the
    reference agree to fp32 rounding: the same GTA, Wigner-D, dropout
    masks, loss, AdamW and renders."""
    config, traffic = tiny(bench, workload, fp32=True)
    values = program_numbers(config, traffic, SEED)
    assert all(v < 5e-6 for v in values.values()), values


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_whole_run_is_correct(bench, workload, trace):
    """A whole run on the CPU, the port computing in fp32 (at a shrunk size
    its bf16 error says nothing of the limits, which the chip's readings
    at the cell's size set); a traced run reports per-layer metrics."""
    config, traffic = tiny(bench, workload, fp32=True)
    result = run.run_cell(bench, workload, SEED, 0.5, trace, device="cpu", config=config, traffic=traffic,
                          t0=time.time())
    assert result["correct"], result["check"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "check" and set(result["check"]) == set(check.limits(workload))
    wanted = {m["name"] for m in (run.per_layer if trace else run.end_to_end)(bench, workload)}
    assert set(result["metrics"]) <= wanted and result["metrics"]
    if trace:
        assert "breakdown" in result and "busy_s" in result["device"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails(bench, workload):
    """The reference in fp8 (the step below the configs' bf16), put in the
    program's place, comes out not correct."""
    config, traffic = tiny(bench, workload)
    lim = check.limits(workload)
    values = {k: v for k, v in program_numbers(config, traffic, SEED, precision="fp8").items() if k in lim}
    assert not check.verdict(values, lim), values


@pytest.mark.parametrize("workload,fault", [("msn_gta_so3.train", "half_batch"), ("msn_srt.train", "half_batch"),
                                            ("msn_gta_so3.serve", "half_batch"),
                                            ("msn_gta_so3.serve", "altered_answer")])
def test_a_broken_timed_path_comes_out_not_correct(bench, workload, fault):
    config, traffic = tiny(bench, workload, fp32=True)
    with calibrate.fault(fault):
        result = run.run_cell(bench, workload, SEED, 0.5, False, device="cpu", config=config, traffic=traffic,
                              t0=time.time())
    assert not result["correct"], result["check"]


@pytest.mark.parametrize("workload", ["msn_gta_so3.train", "msn_srt.train"])
def test_a_step_that_leaves_the_state_unchanged_comes_out_not_correct(bench, workload, monkeypatch):
    from gta_tpu_torch.train.trainer import Trainer

    def unchanged(self, batch, stop=False):
        loss, mse, grads = self.loss_and_grads(batch)
        return {"loss": loss, "mse": mse.mean(), "lr": 0.0, "grad_norm": loss, "stop": stop}

    monkeypatch.setattr(Trainer, "train_step", unchanged)
    config, traffic = tiny(bench, workload, fp32=True)
    result = run.run_cell(bench, workload, SEED, 0.5, False, device="cpu", config=config, traffic=traffic,
                          t0=time.time())
    assert not result["correct"] and result["check"]["change_gap"]["value"] >= 0.99, result["check"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_the_cells_size(bench, card, workload, capsys):
    calibrate.main(["--workload", workload, "--control-seeds", str(SEED), "--device", card])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["summary"]
    lim = check.limits(workload)
    assert not check.verdict({k: summary["control"][k] for k in lim}, lim), summary
