"""Reference checkpoints across frameworks: a `model.pt` of the reference
PyTorch implementation (its Checkpoint.save: the `encoder`, `decoder` and
`optimizer` state_dicts and the scalars epoch_it / it / t / loss_val_best /
run_id) into a port run directory that the train CLI resumes from, and a
port checkpoint back into such a file. The port's own copy of the JAX
package's utils/ref_import.py (load_reference_pt, so3_sign_map,
import_reference_checkpoint, export_reference_checkpoint).

  * Weights. The port's parameter names are the reference keys
    (weights.py), with the reference's orientation, so a tensor goes over
    by name as it is: no key map, no transpose. A file key with no port
    parameter, a port parameter the file lacks, or a shape that differs
    raises, naming the key. The one exception is FTL's model-level
    `trans_coeff`: the reference reads an attribute it never defines, so
    its files cannot carry one; the port keeps its init value (a note is
    printed) with zero moments.
  * so3 channels. The port computes its Wigner-D reps in the JAX package's
    real-SH basis, which differs from the reference's by the sign matrix
    S_l = diag(-1 for m < 0). The flip is folded into the weights: the rows
    of every GTA attention's to_qkv / to_q / to_kv weight and the columns
    of its to_out weight that lie in so3 channels (`so3_sign_map`). It is an
    involution, so import and export apply the same map.
  * AdamW moments. The reference's optimizer indexes its state by position
    in its `model.parameters()` (encoder, then decoder: the file's key
    order); the port's by position in its own. They are aligned by name
    (file position -> key -> port parameter), never position to position.
    `exp_avg` transforms like its weight (the so3 signs), `exp_avg_sq` is a
    square and takes none (its absolute value guards the square root). A
    parameter the reference optimizer never stepped (lazy state) gets zero
    moments. The count is the largest `step`, or `it` when there is none:
    every AdamW `step` is set to it, and the LR schedule so that the next
    step uses schedule(count).

The DiT configs have no reference format; both directions raise for them.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from gta_tpu_torch.config import Config, load_config

SCALAR_KEYS = ("epoch_it", "it", "t", "loss_val_best", "run_id")
MODULES = ("encoder", "decoder")
# FTL's model-level latent-transform coefficient (models/srt.py): absent
# from every reference file
MODEL_LEVEL_KEEP = "trans_coeff"


# ---------------------------------------------------------------------------
# so3 real-SH basis


def so3_signs(n_degrees: int) -> np.ndarray:
    """Signs of one so3 block of degrees 1..n_degrees (sum of 2l + 1
    channels): -1 on the m < 0 channels. A head's so3 span repeats it."""
    parts = []
    for l in range(1, n_degrees + 1):
        s = np.ones(2 * l + 1, np.float32)
        s[:l] = -1.0
        parts.append(s)
    return np.concatenate(parts)


def so3_qkv_sign_fns(attn, heads: int, n_qkv: int):
    """(row_fn, out_col_fn) for one attention layer with `heads` heads:
    row_fn flips the so3 rows (dim 0) of a projection stacking `n_qkv`
    sections (3 for to_qkv, 1 for to_q, 2 for to_kv) of heads x head width
    outputs; out_col_fn flips the matching columns (dim 1) of to_out."""
    fd = attn.gta.f_dims
    ((_, st, ed),) = [s for s in fd.slices() if s[0] == "so3"]
    block = so3_signs(attn.gta.so3)
    head = np.ones(fd.total, np.float32)
    head[st:ed] = np.tile(block, (ed - st) // block.size)
    per_section = torch.from_numpy(np.tile(head, heads))

    def row_fn(w: torch.Tensor) -> torch.Tensor:
        return w * per_section.repeat(n_qkv).to(w)[:, None]

    def out_col_fn(w: torch.Tensor) -> torch.Tensor:
        return w * per_section.to(w)[None, :]

    return row_fn, out_col_fn


def so3_sign_map(cfg: Config) -> Dict[str, Any]:
    """{port key: involution} flipping the m < 0 so3 channels of every GTA
    attention weight (encoder self-attention, decoder cross-attention) of
    the model `cfg` describes; empty without so3. elementwise_mul feeds its
    reps through rep_to_vec, not through channel slices, so it takes none;
    euclid_sim does. Weights only: no bias is flipped."""
    signs = {}
    sides = (("encoder.transformer", cfg.model.encoder, False),
             ("decoder.allocation_transformer.transformer", cfg.model.decoder, True))
    for prefix, side, cross in sides:
        attn = side.attn
        if not (attn.is_gta and attn.gta.f_dims.so3 > 0) or attn.gta.elementwise_mul:
            continue
        for i in range(side.num_att_blocks):
            fn = f"{prefix}.layers.{i}.0.fn"
            if cross:
                signs[f"{fn}.to_q.weight"], _ = so3_qkv_sign_fns(attn, side.heads, 1)
                signs[f"{fn}.to_kv.weight"], out_col = so3_qkv_sign_fns(attn, side.heads, 2)
            else:
                signs[f"{fn}.to_qkv.weight"], out_col = so3_qkv_sign_fns(attn, side.heads, 3)
            signs[f"{fn}.to_out.0.weight"] = out_col
    return signs


def _signed(signs, key: str, value: torch.Tensor) -> torch.Tensor:
    return signs[key](value) if key in signs else value


# ---------------------------------------------------------------------------
# The reference file


def load_reference_pt(path: str, trusted: bool = False):
    """(param_sd, opt_sd, scalars) of a reference `model.pt`: param_sd is
    one flat dict of `encoder.*` then `decoder.*` keys in the file's own
    order (the order its optimizer indexes), opt_sd the optimizer
    state_dict or None, scalars the entries of SCALAR_KEYS it has.

    The load is safe (weights_only): tensors and primitives only. Files
    written by older torch versions may carry numpy scalars, which need
    full unpickling; that can run code embedded in the file, so it is an
    explicit opt-in (`trusted`), never a retry."""
    try:
        raw = torch.load(path, map_location="cpu", weights_only=not trusted)
    except Exception as e:
        if trusted:
            raise
        raise RuntimeError(
            f"safe (weights_only) load of {path} failed: {e}\n"
            "If this checkpoint comes from a source you trust, re-run with "
            "--trusted (full unpickling can execute code embedded in the file)."
        ) from e
    param_sd = {}
    for module in MODULES:
        if module not in raw:
            raise KeyError(f"{path} has no '{module}' state_dict — not a reference checkpoint?")
        for k, v in raw[module].items():
            param_sd[f"{module}.{k}"] = v
    return param_sd, raw.get("optimizer"), {k: raw[k] for k in SCALAR_KEYS if k in raw}


def _moment_dicts(param_sd, opt_sd):
    """(exp_avg, exp_avg_sq, count) of a reference optimizer state_dict:
    the moments by key (the state at position i belongs to the i-th key of
    `param_sd`; zeros for a parameter without state) and the largest
    `step` (0 when no parameter has state)."""
    names = list(param_sd)
    state = {int(k): v for k, v in opt_sd.get("state", {}).items()}
    order = [i for g in opt_sd.get("param_groups", []) for i in g["params"]]
    if len(order) != len(names):
        raise ValueError(f"optimizer has {len(order)} params but checkpoint has {len(names)} — cannot align moments")
    mu, nu, count = {}, {}, 0
    for name, idx in zip(names, order):
        s = state.get(idx)
        if s is None:  # two tensors: an optimizer updates each in place
            mu[name], nu[name] = (torch.zeros_like(torch.as_tensor(param_sd[name])) for _ in range(2))
            continue
        mu[name], nu[name] = s["exp_avg"], s["exp_avg_sq"]
        count = max(count, int(s["step"]))
    return mu, nu, count


# ---------------------------------------------------------------------------
# Port trainers


def _nvs_config(config_path: str) -> Config:
    cfg = load_config(config_path)
    if cfg.model.model_type == "dit":
        raise ValueError(f"{config_path} is a DiT config: the reference implementation has no DiT, so there is no "
                         "reference checkpoint format to import or export")
    return cfg


def _checked(key: str, value, param: torch.Tensor, what: str = "") -> torch.Tensor:
    value = torch.as_tensor(value)
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"{key}{what}: shape {tuple(value.shape)} in the file, {tuple(param.shape)} in the port's "
                         "model")
    return value


def _set_adam_state(trainer, exp_avg: Dict[str, torch.Tensor], exp_avg_sq: Dict[str, torch.Tensor],
                   count: int) -> None:
    """Install the moments (by port key; zeros for a key absent from them)
    into the trainer's optimizer with every `step` at `count`, and set its
    LR schedule so that the next step uses schedule(count), as a trainer
    that took `count` steps holds it."""
    state = {}
    for i, (name, p) in enumerate(trainer.model.named_parameters()):
        # separate zeros for each moment: load_state_dict keeps the tensors
        # it is given where dtype and device match, and steps update them
        # in place
        state[i] = {
            "step": torch.tensor(float(count)),  # a CPU float tensor, as AdamW keeps it
            "exp_avg": _checked(name, exp_avg[name], p, " (exp_avg)") if name in exp_avg else torch.zeros(p.shape),
            "exp_avg_sq": (_checked(name, exp_avg_sq[name], p, " (exp_avg_sq)") if name in exp_avg_sq
                           else torch.zeros(p.shape)),
        }
    opt = trainer.optimizer.state_dict()
    trainer.optimizer.load_state_dict({"state": state, "param_groups": opt["param_groups"]})
    sched = trainer.scheduler
    lrs = [base * lam(count) for lam, base in zip(sched.lr_lambdas, sched.base_lrs)]  # LambdaLR.get_lr at count
    sched.load_state_dict({**sched.state_dict(), "last_epoch": count, "_step_count": count + 1, "_last_lr": lrs})
    for group, lr in zip(trainer.optimizer.param_groups, lrs):
        group["lr"] = lr


def import_reference_checkpoint(config_path: str, pt_path: str, out_dir: str, import_optimizer: bool = True,
                                name: str = "latest", trusted: bool = False,
                                device: Optional[str] = None) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """Convert a reference `model.pt` into the port checkpoint
    `<out_dir>/ckpts/<name>/` (state.pt + scalars.json) that the train
    CLI auto-resumes from with the same config. The trainer is built on
    `device` (default CUDA) with the config's seed, as the train CLI
    builds it. Returns (scalars, parameter counts)."""
    from gta_tpu_torch.train.checkpoint import Checkpointer
    from gta_tpu_torch.train.trainer import Trainer, resolve_device

    device = resolve_device(device)
    cfg = _nvs_config(config_path)
    param_sd, opt_sd, ref_scalars = load_reference_pt(pt_path, trusted=trusted)
    trainer = Trainer(cfg, device=device)
    params = dict(trainer.model.named_parameters())
    keep = {MODEL_LEVEL_KEEP} if cfg.model.ftl else set()
    for key in param_sd:
        if key not in params:
            close = [k for k in params if k.rsplit(".", 2)[-2:] == key.rsplit(".", 2)[-2:]][:4]
            raise KeyError(f"reference key {key} has no parameter in the port's model; close matches: {close}")
    missing = params.keys() - param_sd.keys() - keep
    if missing:
        raise KeyError(f"port parameters never assigned (absent from {pt_path}): {sorted(missing)[:8]}")
    signs = so3_sign_map(cfg)
    with torch.no_grad():
        for key, value in param_sd.items():
            params[key].copy_(_signed(signs, key, _checked(key, value, params[key])))
    for key in sorted(keep - param_sd.keys()):
        print(f"ref_import: keeping init value for {key} (absent from checkpoint)")

    it = int(ref_scalars.get("it", 0))
    if import_optimizer and opt_sd is not None:
        mu, nu, count = _moment_dicts(param_sd, opt_sd)
        for key, value in mu.items():
            mu[key] = _signed(signs, key, _checked(key, value, params[key], " (exp_avg)"))
        _set_adam_state(trainer, mu, {k: torch.as_tensor(v).abs() for k, v in nu.items()}, count or it)
    trainer.step = max(it, 0)

    scalars = {
        "epoch_it": int(ref_scalars.get("epoch_it", -1)),
        "it": it,
        "t": float(ref_scalars.get("t", 0.0)),
    }
    # json keeps +-Infinity (non-strict), as the port's scalar writer does
    if "loss_val_best" in ref_scalars:
        scalars["loss_val_best"] = float(ref_scalars["loss_val_best"])
    if ref_scalars.get("run_id"):
        scalars["run_id"] = ref_scalars["run_id"]
    Checkpointer(out_dir).save(name, trainer, scalars)
    return scalars, trainer.param_counts()


def export_reference_checkpoint(config_path: str, run_dir: str, pt_out: str, name: str = "latest",
                                optimizer_order_from: Optional[str] = None, trusted: bool = False,
                                device: Optional[str] = None) -> Dict[str, Any]:
    """Convert the port checkpoint `<run_dir>/ckpts/<name>/` into a
    reference `model.pt`: the encoder and decoder weights (so3 signs
    applied; FTL's model-level trans_coeff is left out with a note) and
    the scalars of its scalars.json (`it` defaulting to the trainer's
    step). The AdamW moments go in only when `optimizer_order_from` names
    a reference file of the same architecture: the reference indexes them
    by its parameters' positions, which only such a file gives. Returns
    the scalars written."""
    from gta_tpu_torch.train.checkpoint import Checkpointer
    from gta_tpu_torch.train.trainer import Trainer, resolve_device

    device = resolve_device(device)
    cfg = _nvs_config(config_path)
    trainer = Trainer(cfg, device=device)
    scalars = Checkpointer(run_dir).restore(name, trainer)
    signs = so3_sign_map(cfg)

    out: Dict[str, Any] = {module: {} for module in MODULES}
    for key, p in trainer.model.named_parameters():
        module, _, rest = key.partition(".")
        if module in out:
            out[module][rest] = _signed(signs, key, p.detach().cpu().clone())
        else:
            print(f"ref_import: not exporting model-level param {key} (reference checkpoints cannot carry it)")

    if optimizer_order_from is not None:
        order_sd, _, _ = load_reference_pt(optimizer_order_from, trusted=trusted)
        state = trainer.optimizer.state
        mu, nu, count = {}, {}, 0
        for key, p in trainer.model.named_parameters():
            s = state.get(p)
            if s:
                mu[key], nu[key] = s["exp_avg"].cpu().clone(), s["exp_avg_sq"].cpu().clone()
                count = max(count, int(s["step"]))
            else:  # two tensors: a file that shares storage between them loads them shared
                mu[key], nu[key] = torch.zeros(p.shape), torch.zeros(p.shape)
        opt_state = {}
        for i, key in enumerate(order_sd):
            if key not in mu:
                raise KeyError(f"order template param {key} not in exported moments")
            opt_state[i] = {"step": torch.tensor(float(count)), "exp_avg": _signed(signs, key, mu[key]),
                            "exp_avg_sq": nu[key]}
        # the hyperparameter group from a live optimizer of the config's
        # class, so its keys are those of the torch that loads the file
        t = cfg.training
        dummy = torch.nn.Parameter(torch.zeros(1))
        if t.noadamW:
            live = torch.optim.Adam([dummy], lr=float(t.lr))
        else:
            live = torch.optim.AdamW([dummy], lr=float(t.lr), weight_decay=float(t.weight_decay))
        group = dict(live.state_dict()["param_groups"][0], params=list(range(len(order_sd))))
        out["optimizer"] = {"state": opt_state, "param_groups": [group]}

    for k in SCALAR_KEYS:
        if k in scalars:
            out[k] = scalars[k]
    out.setdefault("it", trainer.step)
    os.makedirs(os.path.dirname(os.path.abspath(pt_out)), exist_ok=True)
    torch.save(out, pt_out)
    return {k: out[k] for k in SCALAR_KEYS if k in out}
