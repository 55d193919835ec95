"""The CPU-side logic of the port's card scripts: chip_smoke.py's names for
the kernels in nvcc's build report, the delta emulation of
gta_tpu_torch/scripts/probe_delta_from_o.py against flash_core's plain
backward, and time_kernels.py's digest and config choice; the reference
checkpoint CLIs (import -> a resumed train CLI step -> export) with
--device cpu, and their refusal without CUDA."""

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from gta_tpu_torch.ops import flash_core as fc
from gta_tpu_torch.scripts import probe_delta_from_o


@pytest.mark.parametrize("mangled,label", [
    ("_ZN4sm9013attn_sm90_fwdINS_3CfgILi64ELi128EEEEEv14CUtensorMap_stS2_S2_iPKfP13__nv_bfloat16",
     "sm90::attn_sm90_fwd<Cfg<64, 128>>"),
    ("_ZN4sm9015attn_sm90_bwd_qINS_3CfgILi64ELi64EEE13__nv_bfloat16EEvK14CUtensorMap_st",
     "sm90::attn_sm90_bwd_q<Cfg<64, 64>, __nv_bfloat16>"),
    ("_ZN4sm9016attn_sm90_bwd_kvINS_3CfgILi96ELi64EEEfEEvK14CUtensorMap_st",
     "sm90::attn_sm90_bwd_kv<Cfg<96, 64>, float>"),
    ("_ZN4attn18attn_bwd_kv_kernelILi96ELi2EEEvPKfS2_", "attn::attn_bwd_kv_kernel<96, 2>"),
    ("_ZN8gta_rows19gta_rows_mma_kernelILi64ELi1E13__nv_bfloat16fEEvNS_6RowJobIT1_T2_EEii",
     "gta_rows::gta_rows_mma_kernel<64, 1, __nv_bfloat16, float>"),
    ("_ZN4attn15attn_fwd_kernelILi64EEEvPKf", "attn::attn_fwd_kernel<64>"),
    ("plain_c_symbol", "plain_c_symbol"),
])
def test_kernel_label_names_template_kernels(mangled, label):
    """Namespaces, name and template arguments, a nested class template
    argument (the sm90 core's `Cfg`) with its own arguments."""
    assert chip_smoke.kernel_label(mangled) == label


def test_ptxas_report_gives_one_line_per_kernel():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN4sm9013attn_sm90_fwdINS_3CfgILi64ELi64EEEEEv' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN4sm9013attn_sm90_fwdINS_3CfgILi64ELi64EEEEEv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 528 bytes cmem[0]",
        "ptxas error   : Entry function uses too much shared data",
    ])
    assert list(chip_smoke.ptxas_report(log)) == [
        "sm90::attn_sm90_fwd<Cfg<64, 64>>: Used 168 registers, used 1 barriers, 528 bytes cmem[0]; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas error   : Entry function uses too much shared data",
    ]


@pytest.mark.parametrize("tq,tk", [(5, 7), (33, 17)])
def test_delta_from_o_emulation_is_the_plain_backward_in_exact_arithmetic(tq, tk):
    """Without the TPU rounding (no mxu_dtype) and with the forward's fp32
    output, delta = rowsum(g * o) equals the plain backward's
    rowsum(p * dp): the probe's emulation differs from the plain
    version only in where delta comes from."""
    rng = np.random.default_rng(3)
    heads, c = 2, probe_delta_from_o.C
    q, k, v, g = (torch.from_numpy(rng.normal(size=(2, t, heads * c)).astype(np.float32)) for t in (tq, tk, tk, tq))
    o = fc.flash_core_fwd_plain(q, k, v, heads, c**-0.5)
    got = probe_delta_from_o.bwd_delta_from_o(q, k, v, g, o, heads, None)
    want = fc.flash_core_bwd_plain(q, k, v, heads, c**-0.5, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-4)


def test_time_kernels_digest_tells_bits_apart():
    """The digest covers every tensor of nested outputs and residual
    objects, skips None, and changes with one bit of one element."""
    from gta_tpu_torch.scripts.time_kernels import digest

    class Res:
        def __init__(self, z, lse):
            self.z, self.lse = z, lse

    z = torch.arange(12, dtype=torch.float32).reshape(3, 4).to(torch.bfloat16)
    lse = torch.linspace(0, 1, 5)
    base = digest((z, Res(z.t(), lse), None))
    assert base == digest((z.clone(), Res(z.t().contiguous(), lse.clone()), None))
    flipped = lse.clone()
    flipped.view(torch.int32)[2] ^= 1
    assert digest((z, Res(z.t(), flipped), None)) != base


@pytest.mark.parametrize("names,want", [
    (None, ["clevr_gta", "msn_so3", "clevr_srt", "msn_srt"]),
    (["msn_srt", "clevr_gta"], ["clevr_gta", "msn_srt"]),
])
def test_time_kernels_picks_configs_in_table_order(names, want):
    from gta_tpu_torch.scripts.time_kernels import pick_configs

    assert list(pick_configs(names)) == want


def test_time_kernels_rejects_an_unknown_config():
    from gta_tpu_torch.scripts.time_kernels import pick_configs

    with pytest.raises(SystemExit, match="msn_gta"):
        pick_configs(["msn_srt", "msn_gta"])


FLAGSHIP = "runs/clevrtr/GTA/gta/config.yaml"


def tiny_flagship_yaml(out):
    """The flagship YAML at 32x48 frames, 2 heads of 64, one attention block
    a side, batch 2, printing every step."""
    with open(FLAGSHIP) as f:
        raw = yaml.safe_load(f)
    raw["data"]["num_points"] = 48
    raw["data"]["kwargs"].update(height=32, width=48, downsample=0)
    args = raw["model"]["args"]
    args["encoder_kwargs"].update(dim=64, attdim=128, heads=2, num_att_blocks=1)
    args["decoder_kwargs"].update(z_dim=128, heads=2, rmlp_dim=64, num_att_blocks=1)
    raw["training"].update(batch_size=2, print_every=1, lr_warmup=2, validate_every=0, visualize_every=0)
    with open(out, "w") as f:
        yaml.safe_dump(raw, f)
    return str(out)


def reference_file_of(model, path, it=7, step=7, seed=0):
    """A reference-format model.pt holding `model`'s encoder and decoder
    weights as they are, random AdamW moments (exp_avg_sq positive) at
    `step` for every parameter in the module order, and the scalars;
    returns the dict written."""
    rng = np.random.RandomState(seed)
    modules = {m: {k: v.detach().clone() for k, v in getattr(model, m).state_dict().items()}
               for m in ("encoder", "decoder")}
    tensors = [v for m in modules.values() for v in m.values()]
    state = {i: {"step": torch.tensor(float(step)),
                 "exp_avg": torch.from_numpy(rng.normal(scale=1e-3, size=v.shape).astype(np.float32)),
                 "exp_avg_sq": torch.from_numpy((rng.normal(scale=1e-3, size=v.shape) ** 2).astype(np.float32))}
             for i, v in enumerate(tensors)}
    group = dict(torch.optim.AdamW([torch.nn.Parameter(torch.zeros(1))]).state_dict()["param_groups"][0],
                 params=list(range(len(tensors))))
    out = {**modules, "optimizer": {"state": state, "param_groups": [group]}, "epoch_it": 2, "it": it, "t": 12.5,
           "loss_val_best": 31.25, "run_id": "r3test"}
    torch.save(out, path)
    return out


def test_reference_checkpoint_clis_import_resume_and_export(tmp_path, capsys):
    """import CLI -> one step of the train CLI, resumed at the file's it ->
    export CLI with the file as order template: the weights the train step
    left, the moments at step 8, the scalars of the resumed run."""
    from gta_tpu_torch.config import load_config
    from gta_tpu_torch.scripts import export_reference_checkpoint as export_cli
    from gta_tpu_torch.scripts import import_reference_checkpoint as import_cli
    from gta_tpu_torch.train import __main__ as t_train
    from gta_tpu_torch.train.checkpoint import Checkpointer
    from gta_tpu_torch.train.trainer import Trainer

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yml = tiny_flagship_yaml(tmp_path / "config.yaml")
        pt, run, out_pt = (str(tmp_path / n) for n in ("model.pt", "run", "exported.pt"))
        written = reference_file_of(Trainer(load_config(yml), device="cpu", seed=3).model, pt)
        import_cli.main([yml, pt, run, "--device", "cpu"])
        log = capsys.readouterr().out
        assert f"Imported {pt} -> {run}/ckpts/latest (it=7, params: encoder " in log
        t_train.main([yml, "--synthetic", "--outdir", run, "--device", "cpu", "--exit-after", "7"])
        log = capsys.readouterr().out
        assert "Resumed from checkpoint at it=7" in log and "it=7, loss=" in log and "Iteration limit reached" in log
        export_cli.main([yml, run, out_pt, "--optimizer-order-from", pt, "--device", "cpu"])
        assert f"Exported {run}/ckpts/latest -> {out_pt} (it=7)" in capsys.readouterr().out
    finally:
        torch.set_num_threads(threads)

    got = torch.load(out_pt, weights_only=True)
    trainer = Trainer(load_config(yml), device="cpu")
    Checkpointer(run).restore("latest", trainer)
    assert trainer.step == 8
    for m in ("encoder", "decoder"):
        assert list(got[m]) == list(written[m])
        for k, v in getattr(trainer.model, m).state_dict().items():
            assert torch.equal(got[m][k], v), k  # no so3 channels: the weights as they are
    state = got["optimizer"]["state"]
    assert sorted(state) == sorted(written["optimizer"]["state"])
    assert all(float(s["step"]) == 8 for s in state.values())
    assert not any(torch.equal(s["exp_avg"], written["optimizer"]["state"][i]["exp_avg"]) for i, s in state.items())
    # the resumed run opened a new epoch of its loader, as train.py does
    assert {k: got[k] for k in ("epoch_it", "it", "loss_val_best", "run_id")} == {
        "epoch_it": 3, "it": 7, "loss_val_best": 31.25, "run_id": "r3test"}


@pytest.mark.parametrize("script", ["import", "export"])
def test_reference_checkpoint_clis_raise_without_cuda(script, tmp_path, monkeypatch):
    """Without a card, both scripts raise unless --device cpu is given; they
    raise before reading anything."""
    from gta_tpu_torch.scripts import export_reference_checkpoint as export_cli
    from gta_tpu_torch.scripts import import_reference_checkpoint as import_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = import_cli.main if script == "import" else export_cli.main
    with pytest.raises(RuntimeError, match="CUDA is not available; pass device='cpu'"):
        main([FLAGSHIP, str(tmp_path / "absent.pt"), str(tmp_path / "out")])
