"""The benchmark's manifest, discovery by name, cost arithmetic, kernel
kinds and imports (CPU)."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import cost, kinds, run
from portbench.reference import model_spec

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_names_units_and_files(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    layers = {m["layer"] for m in bench["per_layer"]}
    assert layers <= {"device", "kernels", "model", "entry"}
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        # the manifest alone decides a reader's cells, each of which reports the metric it moves
        assert m["workloads"] and set(m["workloads"]) <= cells, m
        assert all(m["moves"] in {e["name"] for e in run.end_to_end(bench, w)} for w in m["workloads"]), m
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert w["chips"] == 1
        for sub in ("traffic", "limits"):
            key = w["traffic"] if sub == "traffic" else w["name"]
            assert (ROOT / "portbench" / sub / f"{key}.json").is_file()
        for text in (w["why"],):
            assert 1 <= len(text) <= 200 and "\n" not in text


def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in run.end_to_end(bench, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.per_layer(bench, w["name"])


def test_config_sizes_match_what_the_program_parses(bench):
    from gta_tpu_torch.config import config_from_dict

    for c in bench["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        cfg, s = config_from_dict(f["run_config"]), f["sizes"]
        e, d = cfg.model.encoder, cfg.model.decoder
        assert (e.dim, e.attdim, e.num_conv_blocks, e.num_att_blocks, e.heads, e.dropout, e.emb) == tuple(
            s["encoder"][k] for k in ("dim", "attdim", "num_conv_blocks", "num_att_blocks", "heads", "dropout", "emb"))
        assert (d.dim, d.num_att_blocks, d.heads, d.head_dim, d.ff_dim, d.z_dim, d.rmlp_dim, d.dropout, d.emb) == tuple(
            s["decoder"][k] for k in ("dim", "num_att_blocks", "heads", "dim_head", "mlp_dim", "z_dim", "rmlp_dim",
                                      "dropout", "emb"))
        dd = cfg.data
        assert (dd.height, dd.width, dd.num_input_views, dd.num_target_views, dd.num_points, dd.return_transform) == (
            tuple(s["data"][k] for k in ("height", "width", "num_input_views", "num_target_views", "num_points",
                                         "return_transform")))
        assert 2 ** dd.downsample_input_coord == s["data"]["input_coord_stride"] or not s["data"]["return_transform"]
        t = cfg.training
        assert (t.lr, t.lr_warmup, t.decay_it, t.decay_rate, t.weight_decay, t.mixed_prec) == (
            s["training"]["lr"], s["training"]["lr_warmup"], s["training"]["decay_it"], s["training"]["decay_rate"],
            s["training"]["weight_decay"], f["precision"] == "bf16")


@pytest.mark.parametrize("kind_of_file", ["config", "traffic", "metric"])
def test_new_files_are_found_by_name(tmp_path, bench, kind_of_file):
    """A new config, traffic mix or per-layer metric is new files and a new
    manifest entry; the harness reads no list of its own."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    new = json.loads(json.dumps(bench))
    if kind_of_file == "config":
        shutil.copy(root / "portbench/configs/msn_gta_so3.json", root / "portbench/configs/msn_gta_so3_copy.json")
        new["configs"].append(dict(new["configs"][0], name="msn_gta_so3_copy",
                                   file="portbench/configs/msn_gta_so3_copy.json"))
        new["workloads"].append(dict(new["workloads"][0], name="copy.train", config="msn_gta_so3_copy"))
        shutil.copy(root / "portbench/limits/msn_gta_so3.train.json", root / "portbench/limits/copy.train.json")
    elif kind_of_file == "traffic":
        t = json.loads((root / "portbench/traffic/train_b64_pool8.json").read_text())
        (root / "portbench/traffic/train_b32_pool4.json").write_text(json.dumps(dict(t, batch_size=32, pool=4)))
        new["workloads"].append(dict(new["workloads"][0], name="copy.train", traffic="train_b32_pool4"))
        shutil.copy(root / "portbench/limits/msn_gta_so3.train.json", root / "portbench/limits/copy.train.json")
    else:
        (root / "portbench/metrics/steps.train.py").write_text("def read(w):\n    return float(w.steps)\n")
        new["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher", "source": "host_clock",
                                 "layer": "entry", "moves": "train_samples_per_s",
                                 "workloads": ["msn_gta_so3.train", "msn_srt.train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    code = f"""
import json, sys
from portbench import run
bench = run.load_json(run.ROOT / "BENCHMARK.json")
out = {{}}
for w in bench["workloads"]:
    cell, config, traffic = run.cell_files(bench, w["name"])
    out[w["name"]] = [config["name"], traffic["entry"], traffic.get("batch_size"),
                      [m["name"] for m in run.per_layer(bench, w["name"])]]
from portbench.trace import Window
win = Window({{}}, config, traffic, 5, 1.0, [], [])
out["reader"] = run.reader("{'steps.train' if kind_of_file == 'metric' else 'idle_share.train'}")(win)
print(json.dumps(out))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    if kind_of_file == "config":
        assert out["copy.train"][0] == "msn_gta_so3"
    elif kind_of_file == "traffic":
        assert out["copy.train"][1:3] == ["train_step", 32]
    else:
        assert "steps.train" in out["msn_gta_so3.train"][3] and "steps.train" in out["msn_srt.train"][3]
        assert "steps.train" not in out["msn_gta_so3.serve"][3]
        assert out["reader"] == 5.0


@pytest.mark.parametrize("name,expected", [
    ("void sm90::attn_sm90_fwd<sm90::Cfg<96, 64> >(CUtensorMap, CUtensorMap)", "attention_fwd"),
    ("void sm90::attn_sm90_bwd_kv<sm90::Cfg<96, 64> >(...)", "attention_bwd"),
    ("void gta_bwd_dm_bf16_kernel<96>(...)", "attention_bwd"),
    ("void gta_rows_bf16_kernel<float, bf16>(RowJobT<float, bf16>, int)", "attention_rows"),
    ("void centre_bf16_kernel<96>(float const*, Layout, int, float const*, bf16*)", "attention_centres"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "convolution"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("Memcpy DtoH (Device -> Pinned)", "memcpy"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::GeluCUDAKernelImpl>", "other"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float>", "other"),
])
def test_kernel_kinds(name, expected):
    assert kinds.kind(name) == expected


def test_cost_against_hand_counts():
    """A small call counted by hand: B=1, H=2, Tq=4, Tk=8, C=8, two views a
    side, matrices and rotors, v transformed; bf16 operands."""
    c = cost.AttnCall("gta_fused", 1, 2, 4, 8, 8, nq=2, nk=2, mats=True, rotors=True)
    core, chains = 4 * 4 * 8 * 8, 2 * 8 * 8 * (4 * 2 + 8 * 2)  # q k^T and P v; q and out, k and v
    tables = 8 * 8 * (2 + 2 + 2) + 2 * 8 * (4 + 8)  # three per-view matrix sets; cos and sin both sides
    assert cost.work(c, "bf16") == (2 * (core + chains), 2 * (2 * 4 * 16 + 2 * 8 * 16) + 4 * tables)
    b = cost.AttnCall("gta_fused", 1, 2, 4, 8, 8, nq=2, nk=2, mats=True, rotors=True, backward=True)
    assert cost.work(b, "bf16") == (2 * (5 * 2 * 4 * 8 * 8 + 2 * chains),
                                    2 * (4 * 4 * 16 + 4 * 8 * 16) + 4 * (tables + 8 * 8 * 6))
    f = cost.AttnCall("flash_core", 2, 2, 4, 8, 8)
    assert cost.work(f, "bf16") == (4 * 2 * 2 * 4 * 8 * 8, 2 * 2 * (4 * 16 + 2 * 8 * 16) + 2 * 2 * 4 * 16)
    assert cost.work(dataclasses_replace(f, backward=True), "bf16") == (
        10 * 2 * 2 * 4 * 8 * 8, 2 * 2 * (2 * 4 * 16 + 2 * 8 * 16) + 2 * 2 * (4 * 16 + 2 * 8 * 16))
    flops, nbytes = cost.work(c, "bf16")
    assert cost.bound_s([c], "bf16") == max(flops / 989e12, nbytes / 3.35e12)


def dataclasses_replace(c, **kw):
    import dataclasses

    return dataclasses.replace(c, **kw)


def test_attention_calls_and_model_flops_by_hand(bench):
    _, cfg, tr = run.cell_files(bench, "msn_gta_so3.train")
    calls = cost.attention_calls(cfg["sizes"], model_spec(cfg)["encoder_attn"], tr)
    assert len(calls) == 2 * (5 + 2)
    enc, dec = calls[0], calls[5]
    assert (enc.B, enc.H, enc.Tq, enc.Tk, enc.C, enc.nq, enc.nk) == (64, 8, 1280, 1280, 96, 5, 5)
    assert (dec.B, dec.H, dec.Tq, dec.Tk, dec.C, dec.nq, dec.nk) == (64, 8, 2560, 1280, 96, 5, 5)
    # the render MLP alone, by hand: 2560 rays x (180 x 1536 + 3 x 1536^2 + 1536 x 3) MACs, forward
    mlp = 2560 * (180 * 1536 + 3 * 1536 * 1536 + 1536 * 3) * 2
    total = cost.model_flops(cfg, tr) / 64
    assert 3 * mlp < total < 3 * 60 * mlp
    _, scfg, serve = run.cell_files(bench, "msn_gta_so3.serve")
    assert len(cost.attention_calls(scfg["sizes"], model_spec(scfg)["encoder_attn"], serve)) == 5 + 2
    assert cost.model_flops(scfg, serve) > 16 * 16384 * (180 * 1536 + 3 * 1536 * 1536) * 2


def test_harness_and_reference_load_no_jax():
    """The harness, with the program, loads no module whose top-level name
    is jax, jaxlib, flax or gta_tpu; the reference loads nothing of the
    program either."""
    code = """
import sys, json
import portbench.reference, portbench.weights, portbench.scenes, portbench.cost
ref = sorted({m.split('.')[0] for m in sys.modules})
import portbench.run, portbench.drivers, portbench.check, portbench.trace, portbench.calibrate
from portbench import drivers
import gta_tpu_torch.train.trainer, gta_tpu_torch.config
print(json.dumps([ref, sorted({m.split('.')[0] for m in sys.modules})]))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    ref, everything = json.loads(res.stdout.strip().splitlines()[-1])
    assert "gta_tpu_torch" not in ref
    assert not set(everything) & set(run.FORBIDDEN)
    assert "gta_tpu_torch" in everything


def test_run_refuses_without_a_card_and_without_the_program(tmp_path):
    """No result line without CUDA (here), and none in a directory that
    holds only BENCHMARK.json and portbench/."""
    res = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "msn_srt.train", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and not res.stdout.strip()
    bare = tmp_path / "bare"
    shutil.copytree(ROOT / "portbench", bare / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", bare / "BENCHMARK.json")
    res = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "msn_srt.train", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=bare, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and not res.stdout.strip()


def test_trace_arithmetic(bench):
    """Busy time is the union of kernel intervals; the idle share reads the
    profiled window, `mfu` the unprofiled one; a roofline with no attention
    kernel in the trace is left out."""
    from portbench import trace

    _, config, traffic = run.cell_files(bench, "msn_gta_so3.train")
    kernels = [("vectorized_elementwise_kernel", 0.0, 400.0), ("nvjet_tst_128x256", 300.0, 500.0),
               ("void sm90::attn_sm90_fwd<sm90::Cfg<96, 64> >", 700.0, 800.0)]
    assert trace.union_s(kernels) == pytest.approx(600e-6)
    assert trace.gaps(kernels) == [(500.0, 700.0)]
    w = trace.Window({}, config, traffic, 2, 1e-3, kernels, [], flops_per_step=1e9, timed_s=5e-4)
    assert trace.idle_share(w) == pytest.approx(40.0)
    assert trace.mfu(w) == pytest.approx(100.0 * 2e9 / (5e-4 * cost.PEAK_FLOPS["bf16"]))
    assert trace.roofline(w) > 0
    assert trace.roofline(dataclasses_replace(w, kernels=kernels[:2])) is None
