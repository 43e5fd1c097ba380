"""Plain float32 PyTorch of the stage-1 models, written from their published
equations (the FLUX.1 DiT and autoencoder, the CLIP ViT-L/14 vision side,
GenHancer's projectors and the fork's VisualPromptAdapter).

Nothing here imports the program under test.  Parameters are one flat
``{name: tensor}`` dict under the published checkpoints' names
(``double_blocks.0.img_attn.qkv.weight``, ``encoder.down.0.block.0.conv1.
weight``, ``vision_model.encoder.layers.0.self_attn.q_proj.weight`` ...),
prefixed by the component (``dit.``, ``vae.``, ``clip.model.``,
``clip.project_clip.``, ``clip.project_t5.``, ``visual_adapter.``).
``param_shapes`` lists every parameter the stage-1 step reads, in one fixed
order, from the sizes of a benchmark configuration file.

Attention is the plain product ``softmax(q k^T / sqrt(d)) v`` in float32,
RoPE rotates interleaved channel pairs (FLUX's convention), and every norm,
activation and product runs in float32 with TF32 off (``set_precision``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def set_precision() -> None:
    """Full float32 products and convolutions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# parameter lists
# ---------------------------------------------------------------------------

def _lin_s(name: str, out_dim: int, in_dim: int, bias: bool = True) -> List[Tuple[str, tuple]]:
    return [(f"{name}.weight", (out_dim, in_dim))] + ([(f"{name}.bias", (out_dim,))] if bias else [])


def _norm_s(name: str, dim: int) -> List[Tuple[str, tuple]]:
    return [(f"{name}.weight", (dim,)), (f"{name}.bias", (dim,))]


def _conv_s(name: str, out_ch: int, in_ch: int, k: int) -> List[Tuple[str, tuple]]:
    return [(f"{name}.weight", (out_ch, in_ch, k, k)), (f"{name}.bias", (out_ch,))]


def dit_shapes(d: dict) -> List[Tuple[str, tuple]]:
    h, hd = d["hidden_size"], d["hidden_size"] // d["num_heads"]
    mh = int(h * d["mlp_ratio"])
    out = (_lin_s("img_in", h, d["in_channels"])
           + _lin_s("time_in.in_layer", h, 256) + _lin_s("time_in.out_layer", h, h)
           + _lin_s("vector_in.in_layer", h, d["vec_in_dim"]) + _lin_s("vector_in.out_layer", h, h)
           + _lin_s("txt_in", h, d["context_in_dim"]))
    for i in range(d["depth"]):
        for s in ("img", "txt"):
            b = f"double_blocks.{i}.{s}"
            out += (_lin_s(f"{b}_mod.lin", 6 * h, h)
                    + _lin_s(f"{b}_attn.qkv", 3 * h, h, d["qkv_bias"])
                    + [(f"{b}_attn.norm.query_norm.scale", (hd,)),
                       (f"{b}_attn.norm.key_norm.scale", (hd,))]
                    + _lin_s(f"{b}_attn.proj", h, h)
                    + _lin_s(f"{b}_mlp.0", mh, h) + _lin_s(f"{b}_mlp.2", h, mh))
    for i in range(d["depth_single_blocks"]):
        b = f"single_blocks.{i}"
        out += (_lin_s(f"{b}.linear1", 3 * h + mh, h) + _lin_s(f"{b}.linear2", h, h + mh)
                + [(f"{b}.norm.query_norm.scale", (hd,)), (f"{b}.norm.key_norm.scale", (hd,))]
                + _lin_s(f"{b}.modulation.lin", 3 * h, h))
    out += _lin_s("final_layer.linear", d["in_channels"], h) + _lin_s(
        "final_layer.adaLN_modulation.1", 2 * h, h)
    if d["guidance_embed"]:
        out += _lin_s("guidance_in.in_layer", h, 256) + _lin_s("guidance_in.out_layer", h, h)
    return [("dit." + n, s) for n, s in out]


def _resnet_shapes(name: str, cin: int, cout: int) -> List[Tuple[str, tuple]]:
    out = (_norm_s(f"{name}.norm1", cin) + _conv_s(f"{name}.conv1", cout, cin, 3)
           + _norm_s(f"{name}.norm2", cout) + _conv_s(f"{name}.conv2", cout, cout, 3))
    if cin != cout:
        out += _conv_s(f"{name}.nin_shortcut", cout, cin, 1)
    return out


def vae_encoder_shapes(v: dict) -> List[Tuple[str, tuple]]:
    ch, mult = v["ch"], list(v["ch_mult"])
    in_mult = [1] + mult
    out = _conv_s("encoder.conv_in", ch, v["in_channels"], 3)
    for i in range(len(mult)):
        cin, cout = ch * in_mult[i], ch * mult[i]
        for j in range(v["num_res_blocks"]):
            out += _resnet_shapes(f"encoder.down.{i}.block.{j}", cin, cout)
            cin = cout
        if i != len(mult) - 1:
            out += _conv_s(f"encoder.down.{i}.downsample.conv", cout, cout, 3)
    c = ch * mult[-1]
    out += _resnet_shapes("encoder.mid.block_1", c, c)
    out += (_norm_s("encoder.mid.attn_1.norm", c) + _conv_s("encoder.mid.attn_1.q", c, c, 1)
            + _conv_s("encoder.mid.attn_1.k", c, c, 1) + _conv_s("encoder.mid.attn_1.v", c, c, 1)
            + _conv_s("encoder.mid.attn_1.proj_out", c, c, 1))
    out += _resnet_shapes("encoder.mid.block_2", c, c)
    out += _norm_s("encoder.norm_out", c) + _conv_s("encoder.conv_out", 2 * v["z_channels"], c, 3)
    return [("vae." + n, s) for n, s in out]


def tower_shapes(t: dict) -> List[Tuple[str, tuple]]:
    h, g = t["hidden_size"], t["image_size"] // t["patch_size"]
    vm = "vision_model"
    out = [(f"{vm}.embeddings.class_embedding", (h,)),
           (f"{vm}.embeddings.patch_embedding.weight", (h, 3, t["patch_size"], t["patch_size"])),
           (f"{vm}.embeddings.position_embedding.weight", (g * g + 1, h))]
    out += _norm_s(f"{vm}.pre_layrnorm", h)
    for i in range(t["num_layers"]):
        b = f"{vm}.encoder.layers.{i}"
        out += _norm_s(f"{b}.layer_norm1", h)
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += _lin_s(f"{b}.self_attn.{p}", h, h)
        out += (_norm_s(f"{b}.layer_norm2", h) + _lin_s(f"{b}.mlp.fc1", t["intermediate_size"], h)
                + _lin_s(f"{b}.mlp.fc2", h, t["intermediate_size"]))
    out += _norm_s(f"{vm}.post_layernorm", h)
    out += [("visual_projection.weight", (t["projection_dim"], h))]
    return [("clip.model." + n, s) for n, s in out]


def projector_shapes(name: str, in_dim: int, out_dim: int) -> List[Tuple[str, tuple]]:
    return [(f"{name}.{n}", s) for n, s in
            _norm_s("0", in_dim) + _lin_s("1", out_dim, in_dim) + _lin_s("3", out_dim, out_dim)]


def adapter_shapes(in_dim: int, out_dim: int) -> List[Tuple[str, tuple]]:
    return [(f"visual_adapter.proj.{n}", s) for n, s in
            _lin_s("0", 2 * in_dim, in_dim) + _lin_s("2", out_dim, 2 * in_dim) + _norm_s("3", out_dim)]


def param_shapes(model: dict) -> List[Tuple[str, tuple]]:
    """Every parameter the stage-1 step of ``model`` (a configuration file's
    ``model`` group) reads, in one fixed order."""
    t = model["tower"]
    out = dit_shapes(model["dit"]) + vae_encoder_shapes(model["vae"]) + tower_shapes(t)
    if model["mode"] == "image":
        p = model["projectors"]
        out += (projector_shapes("clip.project_clip", t["projection_dim"], p["clip_dim"])
                + projector_shapes("clip.project_t5", t["projection_dim"], p["t5_dim"]))
    else:
        out += adapter_shapes(t["hidden_size"], model["projectors"]["t5_dim"])
    return out


def trainable(model: dict, name: str) -> bool:
    """The leaves stage 1 trains: the DiT and the projectors (image) or the
    adapter (video); the VAE and the tower are frozen."""
    if name.startswith("dit."):
        return True
    if model["mode"] == "image":
        return name.startswith(("clip.project_clip.", "clip.project_t5."))
    return name.startswith("visual_adapter.")


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def linear(P: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, P[f"{name}.weight"], P.get(f"{name}.bias"))


def layernorm(x: torch.Tensor, eps: float, P: Params = None, name: str = None) -> torch.Tensor:
    w = P[f"{name}.weight"] if P is not None else None
    b = P[f"{name}.bias"] if P is not None else None
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v [B, H, L, D] -> [B, H, L, D]."""
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.matmul(torch.softmax(s, dim=-1), v)


def rope_tables(ids: torch.Tensor, axes_dim, theta: float):
    """ids [B, L, n_axes] -> cos, sin [B, L, D/2]: per axis of width d the
    angles ``pos / theta^(2i/d)``."""
    cos, sin = [], []
    for i, d in enumerate(axes_dim):
        omega = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                             device=ids.device) / d)
        ang = ids[..., i].float()[..., None] * omega
        cos.append(torch.cos(ang))
        sin.append(torch.sin(ang))
    return torch.cat(cos, -1), torch.cat(sin, -1)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the interleaved channel pairs (2i, 2i+1) of x [B, L, H, D]."""
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    xe, xo = x[..., 0::2], x[..., 1::2]
    return torch.stack([c * xe - s * xo, s * xe + c * xo], -1).reshape(x.shape)


def timestep_embedding(t: torch.Tensor, dim: int = 256, max_period: float = 10_000.0
                       ) -> torch.Tensor:
    """FLUX's sinusoidal embedding of ``t`` (already scaled by 1000), [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32) / half)
    args = t.float()[:, None] * freqs.to(t.device)[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


def grid_ids(h: int, w: int, t: float, device) -> torch.Tensor:
    """[h*w, 3] ids (t, row, col)."""
    rows = torch.arange(h, dtype=torch.float32, device=device).repeat_interleave(w)
    cols = torch.arange(w, dtype=torch.float32, device=device).repeat(h)
    return torch.stack([torch.full_like(rows, float(t)), rows, cols], -1)


# ---------------------------------------------------------------------------
# DiT (FLUX.1 with GenHancer's depth)
# ---------------------------------------------------------------------------

def _embedder(P, name, x):
    return linear(P, f"{name}.out_layer", F.silu(linear(P, f"{name}.in_layer", x)))


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, hd = x.shape
    return x.reshape(b, l, heads, hd // heads)


def _joint_attention(q, k, v, cos, sin):
    """[B, L, H, D] each -> [B, L, H*D]: RoPE on q and k, plain attention."""
    q, k = rope(q, cos, sin), rope(k, cos, sin)
    o = plain_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    b, h, l, d = o.shape
    return o.transpose(1, 2).reshape(b, l, h * d)


def _qkv(P, name_norm, qkv, heads):
    """Packed [q | k | v] [B, L, 3*H*D] -> per-head q, k, v, q and k RMS-normed."""
    q, k, v = (_heads(x, heads) for x in qkv.chunk(3, -1))
    q = rmsnorm(q, P[f"{name_norm}.query_norm.scale"])
    k = rmsnorm(k, P[f"{name_norm}.key_norm.scale"])
    return q, k, v


def _modulated(x, shift, scale):
    return (1 + scale) * layernorm(x, 1e-6) + shift


def _double_block(P, b, img, txt, vec, cos, sin, heads):
    im = linear(P, f"{b}.img_mod.lin", F.silu(vec))[:, None].chunk(6, -1)
    tm = linear(P, f"{b}.txt_mod.lin", F.silu(vec))[:, None].chunk(6, -1)
    iq, ik, iv = _qkv(P, f"{b}.img_attn.norm",
                      linear(P, f"{b}.img_attn.qkv", _modulated(img, im[0], im[1])), heads)
    tq, tk, tv = _qkv(P, f"{b}.txt_attn.norm",
                      linear(P, f"{b}.txt_attn.qkv", _modulated(txt, tm[0], tm[1])), heads)
    attn = _joint_attention(torch.cat([tq, iq], 1), torch.cat([tk, ik], 1),
                            torch.cat([tv, iv], 1), cos, sin)
    n_txt = txt.shape[1]
    ta, ia = attn[:, :n_txt], attn[:, n_txt:]
    img = img + im[2] * linear(P, f"{b}.img_attn.proj", ia)
    img = img + im[5] * linear(P, f"{b}.img_mlp.2", F.gelu(
        linear(P, f"{b}.img_mlp.0", _modulated(img, im[3], im[4])), approximate="tanh"))
    txt = txt + tm[2] * linear(P, f"{b}.txt_attn.proj", ta)
    txt = txt + tm[5] * linear(P, f"{b}.txt_mlp.2", F.gelu(
        linear(P, f"{b}.txt_mlp.0", _modulated(txt, tm[3], tm[4])), approximate="tanh"))
    return img, txt


def _single_block(P, b, x, vec, cos, sin, heads):
    h = x.shape[-1]
    shift, scale, gate = linear(P, f"{b}.modulation.lin", F.silu(vec))[:, None].chunk(3, -1)
    lin1 = linear(P, f"{b}.linear1", _modulated(x, shift, scale))
    q, k, v = _qkv(P, f"{b}.norm", lin1[..., : 3 * h], heads)
    attn = _joint_attention(q, k, v, cos, sin)
    out = linear(P, f"{b}.linear2", torch.cat([attn, F.gelu(lin1[..., 3 * h:],
                                                            approximate="tanh")], -1))
    return x + gate * out


def dit_forward(P: Params, d: dict, img, img_ids, txt, txt_ids, t_embed_in, y, guidance):
    """Velocity [B, L_img, C] of the packed latent ``img`` [B, L_img, C].

    ``t_embed_in`` and ``guidance`` [B] are the values the sinusoidal
    embeddings take (the timestep and the guidance scale times 1000)."""
    p = {k[len("dit."):]: v for k, v in P.items() if k.startswith("dit.")}
    img = linear(p, "img_in", img)
    vec = _embedder(p, "time_in", timestep_embedding(t_embed_in))
    if d["guidance_embed"]:
        vec = vec + _embedder(p, "guidance_in", timestep_embedding(guidance))
    vec = vec + _embedder(p, "vector_in", y)
    txt = linear(p, "txt_in", txt)
    cos, sin = rope_tables(torch.cat([txt_ids, img_ids], 1), d["axes_dim"], d["theta"])
    heads = d["num_heads"]
    for i in range(d["depth"]):
        img, txt = _double_block(p, f"double_blocks.{i}", img, txt, vec, cos, sin, heads)
    x = torch.cat([txt, img], 1)
    for i in range(d["depth_single_blocks"]):
        x = _single_block(p, f"single_blocks.{i}", x, vec, cos, sin, heads)
    img = x[:, txt.shape[1]:]
    shift, scale = linear(p, "final_layer.adaLN_modulation.1", F.silu(vec)).chunk(2, -1)
    return linear(p, "final_layer.linear", _modulated(img, shift[:, None], scale[:, None]))


def latent_size(model: dict) -> int:
    """The VAE latent's side: the image's over 2 per downsampling level."""
    return model["img_size"] // 2 ** (len(model["vae"]["ch_mult"]) - 1)


def pack_latent(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/2)(W/2), C*4], channels ordered (c, ph, pw)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


# ---------------------------------------------------------------------------
# FLUX autoencoder, encoder half
# ---------------------------------------------------------------------------

def _gn_swish(P, name, x):
    x = F.group_norm(x, min(32, x.shape[1]), P[f"{name}.weight"], P[f"{name}.bias"], 1e-6)
    return x * torch.sigmoid(x)


def _conv(P, name, x, stride=1, padding=None):
    w = P[f"{name}.weight"]
    pad = w.shape[-1] // 2 if padding is None else padding
    return F.conv2d(x, w, P[f"{name}.bias"], stride=stride, padding=pad)


def _resnet(P, name, x):
    h = _conv(P, f"{name}.conv1", _gn_swish(P, f"{name}.norm1", x))
    h = _conv(P, f"{name}.conv2", _gn_swish(P, f"{name}.norm2", h))
    if f"{name}.nin_shortcut.weight" in P:
        x = _conv(P, f"{name}.nin_shortcut", x)
    return x + h


def _vae_attn(P, name, x):
    h = F.group_norm(x, min(32, x.shape[1]), P[f"{name}.norm.weight"],
                     P[f"{name}.norm.bias"], 1e-6)
    b, c, hh, ww = h.shape

    def tokens(n):
        return _conv(P, f"{name}.{n}", h).reshape(b, 1, c, hh * ww).transpose(-1, -2)

    o = plain_attention(tokens("q"), tokens("k"), tokens("v"))       # [b, 1, hw, c]
    o = o.transpose(-1, -2).reshape(b, c, hh, ww)
    return x + _conv(P, f"{name}.proj_out", o)


def vae_moments(P: Params, v: dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, 3] in [-1, 1] -> the posterior's moments [B, H/8, W/8, 2z]."""
    p = {k[len("vae."):]: t for k, t in P.items() if k.startswith("vae.")}
    h = _conv(p, "encoder.conv_in", x.permute(0, 3, 1, 2))
    n = len(v["ch_mult"])
    for i in range(n):
        for j in range(v["num_res_blocks"]):
            h = _resnet(p, f"encoder.down.{i}.block.{j}", h)
        if i != n - 1:
            h = _conv(p, f"encoder.down.{i}.downsample.conv", F.pad(h, (0, 1, 0, 1)),
                      stride=2, padding=0)
    h = _resnet(p, "encoder.mid.block_1", h)
    h = _vae_attn(p, "encoder.mid.attn_1", h)
    h = _resnet(p, "encoder.mid.block_2", h)
    h = _conv(p, "encoder.conv_out", _gn_swish(p, "encoder.norm_out", h))
    return h.permute(0, 2, 3, 1)


def vae_latent(P: Params, v: dict, pixels01: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """[0, 1] pixels -> ``scale * (z - shift)``, z drawn from the posterior
    with the given standard-normal ``noise`` [B, h, w, z]."""
    mean, logvar = vae_moments(P, v, (pixels01 - 0.5) / 0.5).chunk(2, -1)
    z = mean + torch.exp(0.5 * logvar) * noise
    return v["scale_factor"] * (z - v["shift_factor"])


# ---------------------------------------------------------------------------
# CLIP ViT vision side
# ---------------------------------------------------------------------------

def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


_ACT = {"quick_gelu": _quick_gelu, "gelu": F.gelu}


def tower_forward(P: Params, t: dict, pixels01: torch.Tensor):
    """[0, 1] pixels [B, H, W, 3] -> (class token = visual_projection(
    post_layernorm(CLS)), patch tokens before post_layernorm [B, g*g, h])."""
    p = {k[len("clip.model."):]: v for k, v in P.items() if k.startswith("clip.model.")}
    vm, eps, heads = "vision_model", t["layer_norm_eps"], t["num_heads"]
    mean = torch.tensor(CLIP_MEAN, device=pixels01.device)
    std = torch.tensor(CLIP_STD, device=pixels01.device)
    px = ((pixels01 - mean) / std).permute(0, 3, 1, 2)
    x = F.conv2d(px, p[f"{vm}.embeddings.patch_embedding.weight"], stride=t["patch_size"])
    b, c = x.shape[:2]
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([p[f"{vm}.embeddings.class_embedding"].expand(b, 1, c), x], 1)
    x = x + p[f"{vm}.embeddings.position_embedding.weight"][None, : x.shape[1]]
    x = layernorm(x, eps, p, f"{vm}.pre_layrnorm")
    act = _ACT[t["hidden_act"]]
    for i in range(t["num_layers"]):
        n = f"{vm}.encoder.layers.{i}"
        hx = layernorm(x, eps, p, f"{n}.layer_norm1")
        q, k, v = (_heads(linear(p, f"{n}.self_attn.{m}", hx), heads).transpose(1, 2)
                   for m in ("q_proj", "k_proj", "v_proj"))
        o = plain_attention(q, k, v).transpose(1, 2).reshape(hx.shape)
        x = x + linear(p, f"{n}.self_attn.out_proj", o)
        hx = layernorm(x, eps, p, f"{n}.layer_norm2")
        x = x + linear(p, f"{n}.mlp.fc2", act(linear(p, f"{n}.mlp.fc1", hx)))
    pooled = layernorm(x[:, 0], eps, p, f"{vm}.post_layernorm")
    return F.linear(pooled, p["visual_projection.weight"]), x[:, 1:]


# ---------------------------------------------------------------------------
# projectors and the adapter
# ---------------------------------------------------------------------------

def projector(P: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm(eps 1e-5) -> Linear -> exact GELU -> Linear."""
    x = layernorm(x, 1e-5, P, f"{name}.0")
    return linear(P, f"{name}.3", F.gelu(linear(P, f"{name}.1", x)))


def visual_adapter(P: Params, x: torch.Tensor) -> torch.Tensor:
    """Linear(d, 2d) -> SiLU -> Linear(2d, out) -> LayerNorm(eps 1e-5)."""
    h = linear(P, "visual_adapter.proj.2", F.silu(linear(P, "visual_adapter.proj.0", x)))
    return layernorm(h, 1e-5, P, "visual_adapter.proj.3")
