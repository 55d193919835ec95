"""The benchmark's plain reference: the SRT / GTA novel-view model in plain
PyTorch, fp32 with TF32 off, with its loss, AdamW, LR schedule and dropout
rule, and the renderer's per-pixel decode.

It imports nothing of the program (`gta_tpu_torch`) nor JAX, and takes
nothing the program made: the benchmark hands it the weights and scenes it
made from the seed (portbench/weights.py, portbench/scenes.py), and it
works out every derived table again (GTA's SE(3), SO(3) Wigner-D and SO(2)
reps, ray encodings, dropout masks). Its parameter names are the published
PyTorch model's state_dict keys, which the program's layers keep, so one
dict of weights loads into both.

The mathematics follows the GTA paper's model (arXiv 2310.10375) as the
run configs state it: a conv stem, a pre-LN transformer encoder over the
patch tokens of the input views, a cross-attention decoder from the target
rays into the scene latent, and a render MLP with a sigmoid. GTA attention
transforms each head's q by the inverse-transpose of its token's group
representation, k and v by their own, and the output by the query's
inverse; the representation is SE(3) 4x4 blocks (translation scaled by the
learned trans_coeff), SO(3) Wigner-D blocks of degrees 1..n (taken from the
camera's rotation, no gradient) and SO(2) rotors of the pixel coordinates,
in that channel order. Attention itself is a plain softmax over the whole
key set. The Wigner-D construction (closed-form small-d matrices in the
real basis, ZYZ Euler angles with gimbal-lock branches) follows the
convention of the model as published; it is rewritten here from that
description.

`Precision("fp8")` is the correctness control: every product's operands
(Linear and conv inputs and weights, q, k, the probabilities and v) are
rounded to float8 e4m3 with a per-tensor scale, and so is the cotangent of
every product's output, so both passes multiply in fp8 with fp32 sums.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude maps to the format's largest value)."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax)).to(x.dtype)
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _RoundOperand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundCotangent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


class Precision:
    """fp32 (nothing rounded) or the fp8 control (module docstring)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.fp8 = name == "fp8"

    def op(self, x: torch.Tensor) -> torch.Tensor:
        return _RoundOperand.apply(x) if self.fp8 else x

    def out(self, y: torch.Tensor) -> torch.Tensor:
        return _RoundCotangent.apply(y) if self.fp8 else y


# ---------------------------------------------------------------------------
# configuration: the run config's nested dict, with the defaults the config
# files state under "sizes"
# ---------------------------------------------------------------------------


def model_spec(config: dict) -> dict:
    """The reference's view of a benchmark config file: its `sizes` block
    (every width and depth, resolved) and the attention options of its
    run config."""
    sizes = config["sizes"]
    args = config["run_config"]["model"]["args"]

    def attn(kw):
        method = (kw.get("attn_args") or {}).get("method") or {}
        name = method.get("name") or ""
        a = method.get("args") or {}
        fd = {k: int(v) for k, v in (a.get("f_dims") or {}).items()}
        return {"method": name, "f_dims": fd, "so2": int(a.get("so2", 0)), "so3": int(a.get("so3", 0)),
                "max_freq": (float(a.get("max_freq_h", 1.0)), float(a.get("max_freq_w", 1.0)))}

    return {"sizes": sizes, "encoder_attn": attn(args["encoder_kwargs"]),
            "decoder_attn": attn(args["decoder_kwargs"])}


# ---------------------------------------------------------------------------
# geometry: encodings, SE(3), SO(2) rotors, real Wigner-D matrices
# ---------------------------------------------------------------------------


def octave_encoding(x: torch.Tensor, octaves: int, start: int) -> torch.Tensor:
    """[..., D] -> [..., 2 D octaves]: all sines, then all cosines, each
    grouped by input dimension with the octave fastest."""
    mult = torch.pow(2.0, torch.arange(start, start + octaves, dtype=torch.float32, device=x.device)) * math.pi
    s = x[..., None] * mult
    return torch.cat([torch.sin(s).flatten(-2), torch.cos(s).flatten(-2)], -1)


def ray_encoding(pos: torch.Tensor, rays: torch.Tensor, pos_start: int) -> torch.Tensor:
    """Camera position (15 octaves from `pos_start`) and ray direction (15
    from 0): 180 channels."""
    return torch.cat([octave_encoding(pos, 15, pos_start), octave_encoding(rays, 15, 0)], -1)


def rigid_inverse(E: torch.Tensor) -> torch.Tensor:
    R, t = E[..., :3, :3], E[..., :3, 3:]
    out = torch.zeros_like(E)
    out[..., :3, :3] = R.transpose(-1, -2)
    out[..., :3, 3:] = -R.transpose(-1, -2) @ t
    out[..., 3, 3] = 1.0
    return out


def translation_mask(tc: torch.Tensor) -> torch.Tensor:
    """[4, 4]: ones, with the translation column's top three entries tc."""
    m = torch.ones((4, 4), dtype=tc.dtype, device=tc.device)
    col = torch.cat([tc.reshape(1).expand(3), torch.ones(1, dtype=tc.dtype, device=tc.device)])
    return torch.cat([m[:, :3], col[:, None]], 1)


def rotor_angles(coord: torch.Tensor, nfreq: int, max_freq: Tuple[float, float]) -> torch.Tensor:
    """[..., 2] pixel coordinates -> [..., 2 nfreq] angles, frequency-major
    (rotor f * 2 + d), frequencies 2^(j+1) / 2^nfreq."""
    freqs = torch.pow(2.0, torch.arange(1.0, nfreq + 1.0, device=coord.device)) / 2.0**nfreq
    mf = torch.tensor(max_freq, dtype=coord.dtype, device=coord.device)
    theta = 2.0 * math.pi * (mf * coord)[..., None, :] * freqs[:, None]
    return theta.flatten(-2)


@lru_cache(maxsize=None)
def _wigner_tables(l: int):
    """(W [n, n, n], zsign) of degree l in the real basis: the small-d
    matrix of beta is sum_p W[:, :, p] cos(b/2)^p sin(b/2)^(2l-p)."""
    n, f = 2 * l + 1, math.factorial
    Wc = np.zeros((n, n, n))
    for mp in range(-l, l + 1):
        for m in range(-l, l + 1):
            pref = math.sqrt(f(l + mp) * f(l - mp) * f(l + m) * f(l - m))
            for s in range(max(0, m - mp), min(l + m, l - mp) + 1):
                Wc[l + mp, l + m, 2 * l + m - mp - 2 * s] += ((-1.0) ** (mp - m + s)) * pref / (
                    f(l + m - s) * f(s) * f(mp - m + s) * f(l - mp - s))
    U = np.zeros((n, n), np.complex128)
    U[l, l] = 1.0
    r = 1.0 / math.sqrt(2.0)
    for m in range(1, l + 1):
        U[l + m, l + m], U[l + m, l - m] = ((-1.0) ** m) * r, r
        U[l - m, l + m], U[l - m, l - m] = -1j * ((-1.0) ** m) * r, 1j * r
    W = np.einsum("ac,cdp,bd->abp", U, Wc.astype(np.complex128), U.conj()).real
    ms = np.arange(-l, l + 1)
    alpha = 0.7
    Z = (U @ np.diag(np.exp(-1j * ms * alpha)) @ U.conj().T).real
    diag = np.diag(np.cos(ms * alpha))
    anti = np.zeros((n, n))
    anti[np.arange(n), n - 1 - np.arange(n)] = np.sin(ms * alpha)  # row a: sin(m_a alpha) at column n-1-a
    zsign = 1.0 if np.allclose(Z, diag + anti) else -1.0
    if not np.allclose(Z, diag + zsign * anti):
        raise AssertionError(f"real z-rotation of degree {l} is not diagonal plus anti-diagonal")
    return W.astype(np.float32), zsign


def _z_rotation(angle: torch.Tensor, l: int) -> torch.Tensor:
    n = 2 * l + 1
    th = angle[..., None] * torch.arange(-l, l + 1, dtype=angle.dtype, device=angle.device)
    eye = torch.eye(n, dtype=angle.dtype, device=angle.device)
    anti = torch.flip(eye, [1])
    return torch.cos(th)[..., :, None] * eye + _wigner_tables(l)[1] * torch.sin(th)[..., :, None] * anti


def wigner_d(R: torch.Tensor, degree: int) -> List[torch.Tensor]:
    """Real Wigner-D matrices of degrees 1..degree of rotations R [..., 3, 3]:
    Z(g3) B(g2) Z(g1) for R = Rz(g3) Ry(g2) Rz(g1)."""
    g2 = torch.atan2(torch.sqrt(R[..., 0, 2] ** 2 + R[..., 1, 2] ** 2), R[..., 2, 2])
    g1 = torch.atan2(R[..., 2, 1], -R[..., 2, 0])
    g3 = torch.atan2(R[..., 1, 2], R[..., 0, 2])
    top, bottom = torch.abs(R[..., 2, 2] - 1.0) < 1e-5, torch.abs(R[..., 2, 2] + 1.0) < 1e-5
    g1 = torch.where(top, torch.atan2(R[..., 1, 0], R[..., 0, 0]), g1)
    g1 = torch.where(bottom, torch.atan2(R[..., 1, 0], -R[..., 0, 0]), g1)
    g3 = torch.where(top | bottom, torch.zeros_like(g3), g3)
    out = []
    for l in range(1, degree + 1):
        ch, sh = torch.cos(g2 / 2.0), torch.sin(g2 / 2.0)
        basis = torch.stack([ch**p * sh ** (2 * l - p) for p in range(2 * l + 1)], -1)
        W = torch.from_numpy(_wigner_tables(l)[0]).to(R.device)
        out.append(_z_rotation(g3, l) @ torch.einsum("abp,...p->...ab", W, basis) @ _z_rotation(g1, l))
    return out


# ---------------------------------------------------------------------------
# GTA: per-slice transforms of [B, H, T, C] heads
# ---------------------------------------------------------------------------


class GTASide:
    """One side's representation (query or key): per-view SE(3) E
    [B, N, 4, 4], per-view Wigner-D blocks, per-token rotor angles."""

    def __init__(self, transforms: Optional[torch.Tensor], coord: Optional[torch.Tensor], attn: dict):
        fd = attn["f_dims"]
        self.views = transforms.shape[1]
        self.E = transforms
        self.D = None
        if fd.get("so3", 0):
            R = rigid_inverse(transforms)[..., :3, :3]
            self.D = [D.detach() for D in wigner_d(R, attn["so3"])]
        self.cos = self.sin = None
        if fd.get("so2", 0):
            theta = rotor_angles(coord.reshape(coord.shape[0], -1, 2), attn["so2"], attn["max_freq"])
            self.cos, self.sin = torch.cos(theta), torch.sin(theta)


def _slices(f_dims: dict):
    cur = 0
    for name in ("triv", "se3", "so3", "so2", "t2"):
        d = f_dims.get(name, 0)
        if d:
            yield name, cur, cur + d
        cur += d


def _per_view(M: torch.Tensor, x: torch.Tensor, views: int, d: int) -> torch.Tensor:
    """y = M[view] x on each d-vector of x's channels; M [B, N, d, d]."""
    B, H, T, C = x.shape
    xr = x.reshape(B, H, views, T // views, C // d, d)
    return torch.einsum("bnij,bhntcj->bhntci", M, xr).reshape(B, H, T, C)


def _rotate(cos, sin, x, inverse=False):
    B, H, T, C = x.shape
    xr = x.reshape(B, H, T, C // 2, 2)
    c, s = cos[:, None], (-sin if inverse else sin)[:, None]
    x0, x1 = xr[..., 0], xr[..., 1]
    return torch.stack([c * x0 - s * x1, s * x0 + c * x1], -1).reshape(B, H, T, C)


def gta_transform(x: torch.Tensor, side: GTASide, attn: dict, role: str, tc: Optional[torch.Tensor]):
    """x [B, H, T, C] transformed by `side`'s representation: role 'q' (the
    inverse transpose), 'kv' (the representation), 'out' (the inverse)."""
    parts = []
    for name, st, ed in _slices(attn["f_dims"]):
        s = x[..., st:ed]
        if name == "se3":
            mask = translation_mask(tc)
            if role == "q":
                s = _per_view((side.E * mask).transpose(-1, -2), s, side.views, 4)
            elif role == "kv":
                s = _per_view(rigid_inverse(side.E) * mask, s, side.views, 4)
            else:
                s = _per_view(side.E * mask, s, side.views, 4)
        elif name == "so3":
            total = sum(D.shape[-1] for D in side.D)
            B, H, T, C = s.shape
            sr = s.reshape(B, H, side.views, T // side.views, C // total, total)
            outs, cur = [], 0
            for D in side.D:
                d = D.shape[-1]
                M = D.transpose(-1, -2) if role == "out" else D
                outs.append(torch.einsum("bnij,bhntcj->bhntci", M, sr[..., cur:cur + d]))
                cur += d
            s = torch.cat(outs, -1).reshape(B, H, T, C)
        elif name == "so2":
            s = _rotate(side.cos, side.sin, s, inverse=role == "out")
        elif name != "triv":
            raise NotImplementedError(f"the reference has no {name} representation")
        parts.append(s)
    return torch.cat(parts, -1)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


class Run:
    """What one forward pass needs besides the weights: the precision, the
    dropout masks of the whole batch in draw order (None: no dropout) and
    the batch rows this pass covers."""

    def __init__(self, prec: Precision, masks: Optional[List[torch.Tensor]] = None, rows=slice(None)):
        self.prec, self.masks, self.rows, self.next = prec, masks, rows, 0

    def dropout(self, x: torch.Tensor, p: float) -> torch.Tensor:
        if self.masks is None or p == 0:
            return x
        keep = self.masks[self.next][self.rows]
        self.next += 1
        return x * keep / (1.0 - p)


class Linear(nn.Module):
    def __init__(self, i: int, o: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(o, i))
        self.bias = nn.Parameter(torch.empty(o)) if bias else None

    def forward(self, x, run: Run):
        y = run.prec.out(F.linear(run.prec.op(x), run.prec.op(self.weight)))
        return y if self.bias is None else y + self.bias


class Conv(nn.Module):
    def __init__(self, i: int, o: int, k: int, stride: int = 1, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(o, i, k, k))
        self.bias = nn.Parameter(torch.empty(o)) if bias else None
        self.stride, self.padding = stride, k // 2

    def forward(self, x, run: Run):
        y = run.prec.out(F.conv2d(run.prec.op(x), run.prec.op(self.weight), None, self.stride, self.padding))
        return y if self.bias is None else y + self.bias[:, None, None]


class Norm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight, self.bias = nn.Parameter(torch.empty(dim)), nn.Parameter(torch.empty(dim))

    def forward(self, x, run: Run):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, 1e-5)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, dropout: float, kv_dim: Optional[int], attn: dict):
        super().__init__()
        self.heads, self.dim_head, self.p, self.attn = heads, dim_head, dropout, attn
        inner = heads * dim_head
        if kv_dim is None:
            self.to_qkv = Linear(dim, 3 * inner, bias=False)
        else:
            self.to_q = Linear(dim, inner, bias=False)
            self.to_kv = Linear(kv_dim, 2 * inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, dim)])
        self.gta = attn["method"] == "gta"
        if self.gta and attn["f_dims"].get("se3", 0):
            self.trans_coeff = nn.Parameter(torch.empty(1))
        else:
            self.trans_coeff = None
        if attn["method"] not in ("gta", ""):
            raise NotImplementedError(f"the reference has no attention method {attn['method']!r}")

    def forward(self, x, z, geo, run: Run):
        prec = run.prec
        if z is None:
            q, k, v = self.to_qkv(x, run).chunk(3, -1)
        else:
            q = self.to_q(x, run)
            k, v = self.to_kv(z, run).chunk(2, -1)
        B, H = x.shape[0], self.heads
        q, k, v = (t.reshape(B, t.shape[1], H, self.dim_head).transpose(1, 2) for t in (q, k, v))
        if self.gta:
            qside, kside = geo
            q = gta_transform(q, qside, self.attn, "q", self.trans_coeff)
            k = gta_transform(k, kside, self.attn, "kv", self.trans_coeff)
            v = gta_transform(v, kside, self.attn, "kv", self.trans_coeff)
        s = prec.out(torch.einsum("bhqc,bhkc->bhqk", prec.op(q), prec.op(k))) * self.dim_head**-0.5
        p = torch.softmax(s, -1)
        o = prec.out(torch.einsum("bhqk,bhkc->bhqc", prec.op(p), prec.op(v)))
        if self.gta:
            o = gta_transform(o, geo[0], self.attn, "out", self.trans_coeff)
        o = o.transpose(1, 2).reshape(B, -1, H * self.dim_head)
        return run.dropout(self.to_out[0](o, run), self.p)


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int, dropout: float):
        super().__init__()
        self.net = nn.ModuleDict({"0": Linear(dim, hidden), "3": Linear(hidden, dim)})
        self.p = dropout

    def forward(self, x, run: Run):
        h = run.dropout(F.gelu(self.net["0"](x, run)), self.p)
        return run.dropout(self.net["3"](h, run), self.p)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm, self.fn = Norm(dim), fn


class Transformer(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, mlp_dim, dropout, kv_dim, attn):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([PreNorm(dim, Attention(dim, heads, dim_head, dropout, kv_dim, attn)),
                           PreNorm(dim, FeedForward(dim, mlp_dim, dropout))])
            for _ in range(depth))

    def forward(self, x, z, geo, run: Run):
        for a, f in self.layers:
            x = x + a.fn(a.norm(x, run), z, geo, run)
            x = x + f.fn(f.norm(x, run), run)
        return x


class ConvBlock(nn.Module):
    def __init__(self, i, h, o):
        super().__init__()
        self.layers = nn.ModuleDict({"0": Conv(i, h, 3), "2": Conv(h, o, 3, stride=2)})

    def forward(self, x, run: Run):
        return F.relu(self.layers["2"](F.relu(self.layers["0"](x, run)), run))


class Encoder(nn.Module):
    def __init__(self, s: dict, attn: dict):
        super().__init__()
        e = s["encoder"]
        self.s, self.attn = e, attn
        idim = 3 + (180 if e["emb"] == "ray" else 0)
        blocks, cur = [ConvBlock(idim, e["dim"] // 8, e["dim"] // 4)], e["dim"] // 4
        for _ in range(1, e["num_conv_blocks"]):
            blocks.append(ConvBlock(cur, cur, 2 * cur))
            cur *= 2
        self.conv_blocks = nn.ModuleList(blocks)
        self.per_patch_linear = Conv(cur, e["attdim"], 1, bias=True)
        self.transformer = Transformer(e["attdim"], e["num_att_blocks"], e["heads"], e["attdim"] // e["heads"],
                                       2 * e["attdim"], e["dropout"], None, attn)

    def forward(self, scene: dict, run: Run):
        images = scene["input_images"]
        B, N, H, W, _ = images.shape
        x = images.reshape(B * N, H, W, 3)
        if self.s["emb"] == "ray":
            pos = scene["input_camera_pos"].reshape(B * N, 1, 1, 3).expand(B * N, H, W, 3)
            x = torch.cat([x, ray_encoding(pos, scene["input_rays"].reshape(B * N, H, W, 3),
                                           self.s["pos_start_octave"])], -1)
        x = x.permute(0, 3, 1, 2)
        for block in self.conv_blocks:
            x = block(x, run)
        x = self.per_patch_linear(x, run)
        x = x.permute(0, 2, 3, 1).reshape(B, -1, self.s["attdim"])
        geo = None
        if self.attn["method"] == "gta":
            side = GTASide(scene["input_transforms"], scene.get("input_coord"), self.attn)
            geo = (side, side)
        return self.transformer(x, None, geo, run), geo


class Decoder(nn.Module):
    def __init__(self, s: dict, attn: dict):
        super().__init__()
        d = s["decoder"]
        self.s, self.attn = d, attn
        at = nn.Module()
        if d["emb"] == "const":
            at.initial_emb = nn.Parameter(torch.empty(d["dim"]))
        elif d["emb"] == "ray":
            at.input_mlp = nn.ModuleDict({"0": Linear(180, 360), "2": Linear(360, d["dim"])})
        else:
            raise NotImplementedError(f"the reference has no decoder embedding {d['emb']!r}")
        at.transformer = Transformer(d["dim"], d["num_att_blocks"], d["heads"], d["dim_head"], d["mlp_dim"],
                                     d["dropout"], d["z_dim"], attn)
        self.allocation_transformer = at
        dims = [d["dim"]] + [d["rmlp_dim"]] * 4 + [3]
        self.render_mlp = nn.ModuleDict({str(2 * i): Linear(dims[i], dims[i + 1]) for i in range(5)})

    def forward(self, z, enc_geo, query: dict, run: Run) -> torch.Tensor:
        """Pixels [B, T, 3] of the queries: `query` holds camera_pos and rays
        [B, T, 3] and, for GTA, transforms [B, Nt, 4, 4] and coord
        [B, Nt, P, 2] (T = Nt P)."""
        at, B, T = self.allocation_transformer, z.shape[0], query["rays"].shape[1]
        if self.s["emb"] == "const":
            x = at.initial_emb.expand(B, T, -1)
        else:
            e = ray_encoding(query["camera_pos"], query["rays"], self.s["pos_start_octave"])
            x = at.input_mlp["2"](F.relu(at.input_mlp["0"](e, run)), run)
        geo = None
        if self.attn["method"] == "gta":
            geo = (GTASide(query["transforms"], query["coord"], self.attn), enc_geo[1])
        h = at.transformer(x, z, geo, run)
        for i in range(4):
            h = F.leaky_relu(self.render_mlp[str(2 * i)](h, run), 0.01)
        return torch.sigmoid(self.render_mlp["8"](h, run))


class Model(nn.Module):
    """The reference model of a benchmark config file (`model_spec`)."""

    def __init__(self, config: dict):
        super().__init__()
        spec = model_spec(config)
        self.sizes = spec["sizes"]
        self.encoder = Encoder(self.sizes, spec["encoder_attn"])
        self.decoder = Decoder(self.sizes, spec["decoder_attn"])

    def dropout_shapes(self, B: int, n_queries: int) -> List[Tuple[Tuple[int, ...], float]]:
        """(shape, rate) of the dropout masks of one training forward pass in
        draw order: each block of the encoder, then of the decoder, draws
        after attention's output projection, after the feed-forward's
        activation and after its output projection."""
        e, d = self.sizes["encoder"], self.sizes["decoder"]
        tokens = self.sizes["data"]["num_input_views"] * self.sizes["data"]["tokens_per_view"]
        shapes = []
        for depth, T, dim, hidden, p in ((e["num_att_blocks"], tokens, e["attdim"], 2 * e["attdim"], e["dropout"]),
                                         (d["num_att_blocks"], n_queries, d["dim"], d["mlp_dim"], d["dropout"])):
            if p:
                shapes += [((B, T, dim), p), ((B, T, hidden), p), ((B, T, dim), p)] * depth
        return shapes

    def forward(self, scene: dict, run: Run) -> torch.Tensor:
        z, geo = self.encoder(scene, run)
        return self.decoder(z, geo, train_queries(scene), run)


def train_queries(scene: dict) -> dict:
    """A training batch's queries, flattened over its target views."""
    B = scene["target_rays"].shape[0]
    return {"camera_pos": scene["target_camera_pos"].reshape(B, -1, 3),
            "rays": scene["target_rays"].reshape(B, -1, 3),
            "transforms": scene.get("target_transforms"), "coord": scene.get("target_coord")}


def exact_fp32() -> None:
    """fp32 products in fp32: TF32 off for matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# training: dropout rule, schedule, AdamW, three steps
# ---------------------------------------------------------------------------


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    """The dropout generator's seed at optimizer step `step`: a 64-bit
    SeedSequence hash of (seed, rank, step), the published trainer's rule
    as the port keeps it."""
    lo, hi = np.random.SeedSequence([seed, rank, step]).generate_state(2, np.uint32)
    return int(lo) | (int(hi) << 32)


def draw_masks(shapes, seed: int, step: int, device) -> List[torch.Tensor]:
    """The keep masks of step `step` for (shape, rate) pairs: uniform draws
    of a generator on `device` seeded by `step_seed`, one call per mask in
    draw order, kept where at least the rate."""
    g = torch.Generator(device=device)
    g.manual_seed(step_seed(seed, step))
    return [torch.rand(shape, generator=g, device=device) >= p for shape, p in shapes]


def learning_rate(training: dict, it: int) -> float:
    """Linear warmup then exponential decay; step `it` (the count of steps
    before it) under warmup has lr * it / warmup, so the first has 0."""
    lr, warm = training["lr"], training["lr_warmup"]
    if it < warm:
        return lr * it / max(warm, 1)
    return lr * training["decay_rate"] ** ((it - warm) / training["decay_it"])


class AdamW:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8) with decoupled weight decay on
    every parameter, fp32 state."""

    def __init__(self, params: Dict[str, torch.Tensor], weight_decay: float):
        self.params, self.wd, self.t = params, weight_decay, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float):
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        bc1, bc2 = 1 - b1**self.t, 1 - b2**self.t
        for k, p in self.params.items():
            g = grads[k]
            p.mul_(1 - lr * self.wd)
            self.m[k].lerp_(g, 1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(bc2)).add_(eps)
            p.addcdiv_(self.m[k], denom, value=-lr / bc1)


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.double())) for k, t in tensors.items()}


def train_readings(config: dict, weights: Dict[str, torch.Tensor], batches: Sequence[dict], seed: int,
                   precision: str = "fp32", sub_batch: int = 16) -> dict:
    """The reference's three training steps from `weights` on `batches`,
    each step's batch in sub-batches of `sub_batch` rows (the gradient of
    the batch mean, summed): each step's loss, each leaf's gradient norm
    at the first step (from AdamW's first moment after it) and each leaf's
    change over the steps."""
    exact_fp32()
    device = next(iter(weights.values())).device
    model = Model(config).to(device)
    model.load_state_dict(weights, strict=True)
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    training, prec = config["sizes"]["training"], Precision(precision)
    opt = AdamW({k: p.data for k, p in params.items()}, training["weight_decay"])
    losses, grad_norms = [], None
    for step, scene in enumerate(batches):
        B = scene["target_pixels"].shape[0]
        n_queries = scene["target_rays"].reshape(B, -1, 3).shape[1]
        masks = draw_masks(model.dropout_shapes(B, n_queries), seed, step, device)
        for p in params.values():
            p.grad = None
        loss = 0.0
        for r0 in range(0, B, sub_batch):
            rows = slice(r0, min(B, r0 + sub_batch))
            part = {k: v[rows] if torch.is_tensor(v) else v for k, v in scene.items()}
            pred = model(part, Run(prec, masks, rows))
            target = part["target_pixels"].reshape(pred.shape)
            mse = ((pred - target) ** 2).mean(dim=(1, 2))
            part_loss = mse.sum() / B
            part_loss.backward()
            loss += float(part_loss.detach())
        del masks
        losses.append(loss)
        opt.step({k: p.grad for k, p in params.items()}, learning_rate(training, step))
        if step == 0:
            grad_norms = leaf_norms({k: m / 0.1 for k, m in opt.m.items()})
    change = leaf_norms({k: params[k].detach() - start[k] for k in params})
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------


def pixel_grid(h: int, w: int, device) -> torch.Tensor:
    """Row-major pixel coordinates (i / h, j / w), [h w, 2]."""
    i = torch.arange(h, dtype=torch.float32, device=device) / h
    j = torch.arange(w, dtype=torch.float32, device=device) / w
    return torch.stack(torch.meshgrid(i, j, indexing="ij"), -1).reshape(-1, 2)


@torch.no_grad()
def render(config: dict, weights: Dict[str, torch.Tensor], scene: dict, novel: torch.Tensor, h: int, w: int,
           precision: str = "fp32", chunk: int = 16384) -> torch.Tensor:
    """Full frames [S, h, w, 3] of scenes `scene` (input fields, S rows)
    seen from `novel` [S, 4, 4] (relative to the canonical view), one scene
    at a time, the queries in chunks of `chunk` pixels."""
    if not config["sizes"]["data"]["return_transform"]:
        raise NotImplementedError("the reference renders only configs whose novel views come as transforms")
    exact_fp32()
    device = novel.device
    model = Model(config).to(device)
    model.load_state_dict(weights, strict=True)
    run = Run(Precision(precision))
    grid = pixel_grid(h, w, device)
    frames = []
    for s in range(novel.shape[0]):
        one = {k: v[s:s + 1] for k, v in scene.items()}
        z, geo = model.encoder(one, run)
        px = []
        for c0 in range(0, h * w, chunk):
            coord = grid[c0:c0 + chunk][None, None]
            n = coord.shape[2]
            rays = one["input_rays"][:, 0].reshape(1, -1, 3)[:, c0:c0 + chunk]
            query = {"camera_pos": one["input_camera_pos"][:, :1].expand(1, n, 3), "rays": rays,
                     "transforms": novel[s:s + 1, None], "coord": coord}
            px.append(model.decoder(z, geo, query, run))
        frames.append(torch.cat(px, 1).reshape(h, w, 3))
    return torch.stack(frames)
