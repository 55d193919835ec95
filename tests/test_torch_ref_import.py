"""The port's reference-checkpoint import and export
(gta_tpu_torch/utils/ref_import.py) against the JAX package's
(gta_tpu/utils/ref_import.py), on the CPU.

No checkpoint of the reference implementation is at hand, so each case
builds reference-format files from JAX-side code only (six published
configs and the flagship with camera_planar embeddings): the JAX init of a
shrunk config (2 heads of the config's head width, the so3 slices kept,
one attention block a side, two for the so3 configs), keyed by
gta_tpu.utils.ref_import's flax_path_to_torch_key, turned to torch
orientation, with JAX's so3 sign map applied; random exp_avg and positive
exp_avg_sq with one parameter left without state; step 7, it 7, epoch_it
2, t 12.5, loss_val_best 31.25, run_id "r3test". Two variants: the keys
in the JAX tree's order, and encoder keys, decoder keys and optimizer
indices permuted together. Each file goes through JAX's importer (its
parts, `jax_import`) and the port's import_reference_checkpoint; then:
  * weights, exp_avg and exp_avg_sq bit-equal after params_from_jax, the
    count, step and scalars equal, the port's next LR JAX's
    warmup_exp_decay(count);
  * one resumed train step on the same batch (dropout 0; fp32, the msn
    config's bf16 policy overridden for the step) within
    test_torch_train.py::test_two_train_steps_match_jax's tolerances;
  * the port's export equals the input file tensor for tensor (the
    stateless parameter comes back with zero moments, as from JAX) and,
    for the base file, JAX's export_reference_checkpoint of JAX's import,
    with the file as order template; without one it has no optimizer
    entry.
Then the so3 sign map against JAX's at the published widths, and the
port's own checks: the safe load, key and shape errors, --no-optimizer,
DiT configs. JAX's exporter makes a throwaway init batch with JAX's
SyntheticScenes, which the tests run on its numpy renderer.
"""

import contextlib
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import gta_tpu.data.synthetic as j_synthetic
import gta_tpu.utils.ref_import as jref
from gta_tpu.config import load_config as j_load_config
from gta_tpu.data.synthetic import collate as j_collate
from gta_tpu.train.checkpoint import Checkpointer as JCheckpointer
from gta_tpu.train.schedule import warmup_exp_decay as j_warmup_exp_decay
from gta_tpu.train.trainer import Trainer as JTrainer
from gta_tpu_torch.config import load_config
from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
from gta_tpu_torch.train.checkpoint import Checkpointer
from gta_tpu_torch.train.trainer import Trainer
from gta_tpu_torch.utils import ref_import
from gta_tpu_torch.weights import params_from_jax

CONFIGS = {
    "gta": "runs/clevrtr/GTA/gta/config.yaml",
    "gta_so3": "runs/clevrtr/GTA/gta_so3/config.yaml",
    "msn_so3_euclid": "runs/msn/GTA/gta_so3_euclid/config.yaml",
    "elementwise_mul": "runs/clevrtr/otherPEs/elementwise_mul/config.yaml",
    "ftl_rope": "runs/clevrtr/otherPEs/ftl_rope/config.yaml",
    "rpe": "runs/clevrtr/otherPEs/rpe/config.yaml",
    "camera_planar": "runs/clevrtr/GTA/gta/config.yaml",
}
# the flagship with camera_planar embeddings in encoder and decoder (no
# published config has them): lin_planar, lin_camera and a 192-wide
# input_mlp.0 in the file
EMB = {"camera_planar": "camera_planar"}
SCALARS = {"epoch_it": 2, "it": 7, "t": 12.5, "loss_val_best": 31.25, "run_id": "r3test"}
STEP = 7
STATELESS = 3  # this encoder key (in the JAX tree's order) has no optimizer state


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: intra-op threads only contend with the parallel test
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_yaml(path, out, emb=None):
    """The YAML at `path` shrunk: 2 heads of the config's head width, 2
    attention blocks a side where the config has so3 channels (the sign
    map's keys per layer) and 1 elsewhere, dropout 0, synthetic scenes at
    32x48 (msn: 32x32) with 48 rays (msn: 40), lr_warmup 2; `emb`, where
    given, in encoder and decoder. The rest (f_dims, the so2 / so3 degrees,
    the attention flags, mixed_prec) is the YAML's."""
    cfg = load_config(path)
    with open(path) as f:
        raw = yaml.safe_load(f)
    head = cfg.model.encoder.attdim // cfg.model.encoder.heads
    msn = cfg.data.num_input_views == 5
    blocks = 2 if cfg.model.encoder.attn.gta.f_dims.so3 else 1
    args = raw["model"]["args"]
    args["encoder_kwargs"].update(dim=64, attdim=2 * head, heads=2, num_att_blocks=blocks, dropout=0.0)
    args["decoder_kwargs"].update(z_dim=2 * head, heads=2, rmlp_dim=64, num_att_blocks=blocks, dropout=0.0)
    if emb is not None:
        args["encoder_kwargs"]["emb"] = args["decoder_kwargs"]["emb"] = emb
    raw["data"].update(dataset="synthetic", num_points=40 if msn else 48)
    raw["data"]["kwargs"].update(height=32, width=32 if msn else 48, downsample=0, num_views=cfg.data.num_views)
    raw["training"].update(lr_warmup=2)
    with open(out, "w") as f:
        yaml.safe_dump(raw, f)
    return str(out)


def _items(cfg, idx):
    ds = SyntheticScenes(cfg.data, "train")
    return [ds[i] for i in idx]


def _jbatch(items):
    return jax.tree.map(jnp.asarray, j_collate(items))


def _torch_oriented(fpath, value):
    if fpath[-1] != "kernel":
        return value
    return value.T if value.ndim == 2 else np.transpose(value, (3, 2, 0, 1))  # Dense / Conv HWIO -> torch


def reference_file(jcfg, jparams, path, permute, seed=0):
    """Write a reference-format model.pt (see the module docstring) from the
    JAX params `jparams` of `jcfg`; returns the dict written."""
    signs = jref.so3_sign_map(jcfg, jparams)
    modules = {"encoder": {}, "decoder": {}}
    for p, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        key = tuple(k.key for k in p)
        value = np.asarray(leaf, np.float32)
        if key in signs:
            value = np.asarray(signs[key](value), np.float32)
        module, _, rest = jref.flax_path_to_torch_key(key[1:]).partition(".")
        if module in modules:  # FTL's model-level trans_coeff: never in a reference file
            modules[module][rest] = torch.from_numpy(np.array(_torch_oriented(key, value)))
    rng = np.random.RandomState(seed)
    names = [f"{m}.{k}" for m in modules for k in modules[m]]
    stateless = names[STATELESS]
    moments = {}
    for name in names:  # by key, in one order, so both variants carry the same values
        shape = modules[name.split(".")[0]][name.split(".", 1)[1]].shape
        mu = rng.normal(scale=1e-3, size=shape).astype(np.float32)
        nu = (rng.normal(scale=1e-3, size=shape) ** 2 + 1e-9).astype(np.float32)
        moments[name] = (torch.from_numpy(mu), torch.from_numpy(nu))
    if permute:
        for m in modules:
            keys = list(modules[m])
            modules[m] = {keys[i]: modules[m][keys[i]] for i in rng.permutation(len(keys))}
        names = [f"{m}.{k}" for m in modules for k in modules[m]]
    state = {i: {"step": torch.tensor(float(STEP)), "exp_avg": moments[n][0], "exp_avg_sq": moments[n][1]}
             for i, n in enumerate(names) if n != stateless}
    t = jcfg.training
    live = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(1))], lr=t.lr, weight_decay=t.weight_decay)
    group = dict(live.state_dict()["param_groups"][0], params=list(range(len(names))))
    out = {**modules, "optimizer": {"state": state, "param_groups": [group]}, **SCALARS}
    torch.save(out, path)
    return out


@contextlib.contextmanager
def _numpy_renderer():
    """JAX's SyntheticScenes on its numpy renderer, inside JAX's importer
    and exporter (they make a throwaway init batch with it)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_synthetic, "SyntheticScenes", functools.partial(j_synthetic.SyntheticScenes, use_native=False))
        yield


def jax_import(jtr, jcfg, template, pt, out_dir):
    """JAX's import_reference_checkpoint (gta_tpu/utils/ref_import.py:534-582)
    by its parts (:342 so3_sign_map, :162 transplant, :427 _moment_dicts,
    :461 _restore_opt_state), on an init state of the same config in place
    of its own init: returns the JAX TrainState and the scalars, both saved
    under `out_dir` as it saves them."""
    param_sd, opt_sd, ref_scalars = jref.load_reference_pt(pt)
    sign_map = jref.so3_sign_map(jcfg, template.params)
    fill = [("ftl_trans_coeff",)] if jcfg.model.ftl else []
    params = jref.transplant(param_sd, template.params, so3_sign=sign_map, fill_missing=fill)
    it = int(ref_scalars.get("it", 0))
    mu_sd, nu_sd, count = jref._moment_dicts(param_sd, opt_sd)
    zeros = jax.tree.map(np.zeros_like, params)
    mu = jref.transplant(mu_sd, zeros, so3_sign=sign_map, fill_missing=fill)
    nu = jax.tree.map(np.abs, jref.transplant(nu_sd, zeros, so3_sign=None, fill_missing=fill))
    opt_state = jref._restore_opt_state(jtr.tx.init(params), mu, nu, count or it)
    state = template.replace(step=jnp.asarray(max(it, 0), jnp.int32), params=params, opt_state=opt_state)
    scalars = {"epoch_it": int(ref_scalars["epoch_it"]), "it": it, "t": float(ref_scalars["t"]),
               "loss_val_best": float(ref_scalars["loss_val_best"]), "run_id": ref_scalars["run_id"]}
    JCheckpointer(out_dir).save("latest", state, scalars)
    return state, scalars


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request, tmp_path_factory):
    """Per config: the tiny YAML, a JAX init, its two reference files, the
    JAX and the port imports of each, and JAX's export_reference_checkpoint
    of its base import with the base file as order template."""
    name = request.param
    tmp = tmp_path_factory.mktemp(f"ref_{name}")
    yml = tiny_yaml(CONFIGS[name], tmp / "config.yaml", EMB.get(name))
    jcfg, tcfg = j_load_config(yml), load_config(yml)
    jtr = JTrainer(jcfg)
    template = jtr.init_state(_jbatch(_items(tcfg, (0, 1))), seed=0)
    out = {"name": name, "yaml": yml, "jcfg": jcfg, "tcfg": tcfg, "jtr": jtr}
    for variant in ("base", "permuted"):
        pt, tdir, jdir = (str(tmp / f"{d}_{variant}") for d in ("file", "port", "jax"))
        written = reference_file(jcfg, template.params, pt, permute=variant == "permuted")
        t_scalars, t_counts = ref_import.import_reference_checkpoint(yml, pt, tdir, device="cpu")
        jstate, j_scalars = jax_import(jtr, jcfg, template, pt, jdir)
        out[variant] = dict(pt=pt, written=written, tdir=tdir, jdir=jdir, jstate=jstate, t_scalars=t_scalars,
                            j_scalars=j_scalars, t_counts=t_counts, j_counts=jtr.param_counts(jstate))
    base = out["base"]
    base["jax_export"] = str(tmp / "jax_export.pt")
    with _numpy_renderer():
        jref.export_reference_checkpoint(yml, base["jdir"], base["jax_export"], optimizer_order_from=base["pt"])
    return out


def _port_trainer(case, variant, cfg=None):
    """A port Trainer on the CPU restored from the variant's import."""
    ttr = Trainer(cfg or case["tcfg"], device="cpu")
    assert Checkpointer(case[variant]["tdir"]).restore("latest", ttr) == case[variant]["t_scalars"] == SCALARS
    return ttr


def _port_moments(ttr):
    state = ttr.optimizer.state
    return {name: state[p] for name, p in ttr.model.named_parameters()}


@pytest.mark.parametrize("variant", ["base", "permuted"])
def test_import_matches_jax(case, variant):
    v = case[variant]
    jstate, ttr = v["jstate"], _port_trainer(case, variant)
    assert v["t_counts"] == v["j_counts"] and v["j_scalars"] == SCALARS
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    got = dict(ttr.model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        assert torch.equal(p.detach(), want[name]), name
    adam = jref._find_adam_state(jstate.opt_state)
    mu = params_from_jax(jax.tree.map(np.asarray, adam.mu))
    nu = params_from_jax(jax.tree.map(np.asarray, adam.nu))
    count = int(adam.count)
    assert count == STEP and ttr.step == int(jstate.step) == SCALARS["it"]
    for name, s in _port_moments(ttr).items():
        assert torch.equal(s["exp_avg"], mu[name]), name
        assert torch.equal(s["exp_avg_sq"], nu[name]), name
        assert s["step"].dtype == torch.float32 and s["step"].device.type == "cpu" and float(s["step"]) == count
    t = case["tcfg"].training
    sched = j_warmup_exp_decay(t.lr, t.lr_warmup, t.decay_it, t.decay_rate)
    lr = ttr.scheduler.get_last_lr()[0]
    assert lr == pytest.approx(float(sched(count)), rel=1e-6) and lr > 0
    assert ttr.optimizer.param_groups[0]["lr"] == lr and ttr.scheduler.last_epoch == count
    if case["name"] == "ftl_rope":  # kept at its init, never stepped
        assert got["trans_coeff"].item() == pytest.approx(0.01)
        assert not _port_moments(ttr)["trans_coeff"]["exp_avg"].any()


def test_resumed_train_step_matches_jax(case):
    """One step from each framework's import of the base file, on the same
    batch, in fp32 (the msn config's bf16 policy overridden)."""
    tcfg, jcfg, jtr = case["tcfg"], case["jcfg"], case["jtr"]
    if tcfg.training.mixed_prec:
        tcfg = dataclasses.replace(tcfg, training=dataclasses.replace(tcfg.training, mixed_prec=False))
        jtr = JTrainer(dataclasses.replace(jcfg, training=dataclasses.replace(jcfg.training, mixed_prec=False)))
    ttr = _port_trainer(case, "base", tcfg)
    items = _items(tcfg, (2, 3))
    jstate = jax.tree.map(jnp.array, case["base"]["jstate"])  # a copy: the JAX train step donates its state
    jstate, want = jtr.train_step(jstate, _jbatch(items), jax.random.PRNGKey(0))
    got = ttr.train_step(collate(items))
    for key in ("loss", "mse", "lr", "grad_norm"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, err_msg=key)
    assert ttr.step == int(jstate.step) == SCALARS["it"] + 1
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for name, p in ttr.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, err_msg=name)


def _assert_same_file(got, want, label):
    assert sorted(got) == sorted(want), label
    for module in ("encoder", "decoder"):
        assert got[module] and sorted(got[module]) == sorted(want[module]), f"{label} {module}"
        for k, v in got[module].items():
            assert v.dtype == torch.float32 and torch.equal(v, want[module][k]), f"{label} {module}.{k}"
    for k in ref_import.SCALAR_KEYS:
        assert got[k] == want[k], f"{label} {k}"
    if "optimizer" in want:
        g, w = got["optimizer"], want["optimizer"]
        assert g["param_groups"] == w["param_groups"], label
        assert sorted(g["state"]) == sorted(w["state"]), label
        for i, s in g["state"].items():
            assert sorted(s) == ["exp_avg", "exp_avg_sq", "step"], f"{label} state {i}"
            for k, v in s.items():
                assert v.dtype == torch.float32 and torch.equal(v, w["state"][i][k]), f"{label} state {i} {k}"


@pytest.mark.parametrize("variant", ["base", "permuted"])
def test_export_equals_the_input_file(case, variant, tmp_path):
    """The port's export of its import, with the file as order template:
    the file itself, tensor for tensor (the parameter without state comes
    back with zero moments at the count, as JAX exports it); of the base
    file also JAX's export of JAX's import. Without a template: the
    weights and scalars, no optimizer entry."""
    v = case[variant]
    written = v["written"]
    names = [f"{m}.{k}" for m in ("encoder", "decoder") for k in written[m]]
    want = {**written, "optimizer": {**written["optimizer"], "state": dict(written["optimizer"]["state"])}}
    for i, n in enumerate(names):
        if i not in want["optimizer"]["state"]:
            m, _, k = n.partition(".")
            zeros = torch.zeros_like(written[m][k])
            want["optimizer"]["state"][i] = {"step": torch.tensor(float(STEP)), "exp_avg": zeros, "exp_avg_sq": zeros}
    assert len(want["optimizer"]["state"]) == len(names) == len(written["optimizer"]["state"]) + 1

    port_pt, bare_pt = str(tmp_path / "port.pt"), str(tmp_path / "bare.pt")
    scalars = ref_import.export_reference_checkpoint(case["yaml"], v["tdir"], port_pt, optimizer_order_from=v["pt"],
                                                     device="cpu")
    assert scalars == SCALARS
    got = torch.load(port_pt, weights_only=True)
    _assert_same_file(got, want, "port export vs input")
    if variant == "base":
        _assert_same_file(got, torch.load(v["jax_export"], weights_only=True), "port export vs JAX export")

    ref_import.export_reference_checkpoint(case["yaml"], v["tdir"], bare_pt, device="cpu")
    bare = torch.load(bare_pt, weights_only=True)
    assert "optimizer" not in bare
    _assert_same_file(bare, {k: x for k, x in want.items() if k != "optimizer"}, "port export without template")


@pytest.mark.parametrize("name", ["gta_so3", "msn_so3_euclid", "elementwise_mul", "gta"])
def test_so3_sign_map_matches_jax(name):
    """At the published widths (6 heads of 64; msn 8 heads of 96, its so3
    span 48:72 of each head between se3 and so2): the same weights, and
    the same flip of each, as JAX's map in flax orientation."""
    path = CONFIGS[name]
    ours, theirs = ref_import.so3_sign_map(load_config(path)), jref.so3_sign_map(j_load_config(path), None)
    assert sorted(ours) == sorted(jref.flax_path_to_torch_key(k[1:]) for k in theirs)
    assert bool(ours) == (name in ("gta_so3", "msn_so3_euclid"))
    rng = np.random.RandomState(0)
    tr = Trainer(load_config(path), device="cpu")
    params = dict(tr.model.named_parameters())
    for key, fn in theirs.items():
        tkey = jref.flax_path_to_torch_key(key[1:])
        w = rng.normal(size=params[tkey].shape).astype(np.float32)
        want = np.asarray(fn(w.T)).T  # JAX flips flax kernels [in, out]
        got = ours[tkey](torch.from_numpy(w)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=tkey)
        flipped = np.nonzero((got != w).any(axis=0 if tkey.endswith("to_out.0.weight") else 1))[0]
        head = load_config(path).model.encoder.attn.gta.f_dims.total
        assert flipped.size and set(flipped % head) <= set(range(*{"gta_so3": (32, 48), "msn_so3_euclid": (48, 72)}[name]))


@pytest.fixture(scope="module")
def tiny_file(tmp_path_factory):
    """(tiny flagship YAML, a reference file of a port model of it)."""
    from tests.test_torch_scripts import reference_file_of, tiny_flagship_yaml

    tmp = tmp_path_factory.mktemp("ref_tiny")
    yml = tiny_flagship_yaml(tmp / "config.yaml")
    pt = str(tmp / "model.pt")
    return yml, pt, reference_file_of(Trainer(load_config(yml), device="cpu", seed=3).model, pt)


def test_safe_load_refuses_numpy_scalars_unless_trusted(tiny_file, tmp_path):
    yml, _, written = tiny_file
    pt = str(tmp_path / "old.pt")
    torch.save({**written, "it": np.int64(5), "t": np.float64(2.5)}, pt)
    with pytest.raises(RuntimeError, match="(?s)safe \\(weights_only\\) load of .* failed.*re-run with --trusted"):
        ref_import.import_reference_checkpoint(yml, pt, str(tmp_path / "a"), device="cpu")
    assert not os.path.exists(tmp_path / "a")
    scalars, _ = ref_import.import_reference_checkpoint(yml, pt, str(tmp_path / "b"), device="cpu", trusted=True)
    assert scalars["it"] == 5 and scalars["t"] == 2.5


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "moment_shape"])
def test_import_checks_the_key_set_and_shapes(tiny_file, tmp_path, fault):
    yml, _, written = tiny_file
    bad = {**written, "encoder": dict(written["encoder"]), "optimizer": {
        **written["optimizer"], "state": {i: dict(s) for i, s in written["optimizer"]["state"].items()}}}
    key = "transformer.layers.0.0.fn.to_qkv.weight"
    if fault == "missing":
        del bad["encoder"][key]
        match = f"never assigned .*encoder.{key}"
    elif fault == "extra":
        bad["encoder"]["transformer.layers.9.0.fn.to_qkv.weight"] = written["encoder"][key]
        match = "reference key encoder.transformer.layers.9.0.fn.to_qkv.weight has no parameter"
    elif fault == "shape":
        bad["encoder"][key] = written["encoder"][key].reshape(-1, 2 * written["encoder"][key].shape[1])
        match = f"encoder.{key}: shape .* in the file, .* in the port's model"
    else:
        i = list(written["encoder"]).index(key)
        bad["optimizer"]["state"][i]["exp_avg"] = bad["optimizer"]["state"][i]["exp_avg"].t()
        match = f"encoder.{key} \\(exp_avg\\): shape"
    if fault in ("missing", "extra"):  # the optimizer follows the key set
        bad["optimizer"] = None
    pt = str(tmp_path / "bad.pt")
    torch.save({k: v for k, v in bad.items() if v is not None}, pt)
    with pytest.raises((KeyError, ValueError), match=match):
        ref_import.import_reference_checkpoint(yml, pt, str(tmp_path / "out"), device="cpu")
    assert not os.path.exists(tmp_path / "out")


def test_import_without_the_optimizer_starts_it_fresh(tiny_file, tmp_path):
    """--no-optimizer: the weights and `it`, a fresh AdamW and schedule (the
    JAX importer's fresh opt_state, count 0)."""
    yml, pt, written = tiny_file
    ref_import.import_reference_checkpoint(yml, pt, str(tmp_path), import_optimizer=False, device="cpu")
    tr = Trainer(load_config(yml), device="cpu")
    Checkpointer(str(tmp_path)).restore("latest", tr)
    assert tr.step == 7 and not tr.optimizer.state and tr.scheduler.last_epoch == 0
    assert torch.equal(tr.model.encoder.state_dict()["transformer.layers.0.0.fn.to_qkv.weight"],
                       written["encoder"]["transformer.layers.0.0.fn.to_qkv.weight"])


@pytest.mark.parametrize("direction", ["import", "export"])
def test_dit_configs_raise(direction, tmp_path):
    path = "runs/imagenet/DiT/dit_gta/config.yaml"
    with pytest.raises(ValueError, match="DiT config: the reference implementation has no DiT"):
        if direction == "import":
            ref_import.import_reference_checkpoint(path, str(tmp_path / "m.pt"), str(tmp_path), device="cpu")
        else:
            ref_import.export_reference_checkpoint(path, str(tmp_path), str(tmp_path / "m.pt"), device="cpu")
