"""Operation and byte counts of the stage-1 step, and the card's peaks.

A product of ``rows`` rows by a ``[d_out, d_in]`` weight takes ``2 rows d_in
d_out`` operations forward; a trained one takes as many again for its
weight gradient and for its input gradient, the latter only where its
input carries a gradient (the DiT's ``img_in`` takes the noised latent,
the time and guidance embedders take constants).  The adaLN modulations act
on one row per sample, not per token.  A convolution is ``2 x output
elements x c_in k^2``.  Attention is ``4 B H L^2 D`` forward (two products)
and ``8 B H L^2 D`` backward (four), RoPE ``3`` operations per rotated
element each way.  Frozen modules (the VAE encoder, the tower) run forward
only, and nothing counts a recompute.

The peaks and the bound arithmetic are those of ``chip_smoke.py``
``_set_bound``: the least time of a call is the larger of its operations at
the dense bf16 rate and its bytes at the HBM rate of one H100 SXM.
"""

from __future__ import annotations

from typing import Dict, Tuple

# one NVIDIA H100 SXM (data sheet, dense): operations per second by type,
# HBM bytes per second
PEAK_OPS = {"bfloat16": 989e12, "float16": 989e12, "int8": 1979e12, "tf32": 495e12,
            "float32": 67e12}
PEAK_BYTES = 3.35e12


def least_seconds(ops: float, n_bytes: float, dtype: str = "bfloat16") -> Tuple[float, str]:
    """(the least time of ``ops`` operations and ``n_bytes`` bytes, which bounds it)."""
    t_ops, t_bytes = ops / PEAK_OPS[dtype], n_bytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def linear(rows: int, d_in: int, d_out: int, trained: bool = False,
           input_grad: bool = True) -> Tuple[int, int]:
    """(forward, backward) operations of one product."""
    fwd = 2 * rows * d_in * d_out
    if not trained:
        return fwd, 0
    return fwd, fwd * (2 if input_grad else 1)


def conv2d(batch: int, h_out: int, w_out: int, c_in: int, c_out: int, k: int) -> int:
    """Forward operations of one convolution."""
    return 2 * batch * h_out * w_out * c_out * c_in * k * k


def attention(b: int, l: int, h: int, d: int, rope: bool = False,
              trained: bool = True) -> Tuple[int, int]:
    """(forward, backward) operations of one attention call over ``l`` tokens."""
    fwd = 4 * b * h * l * l * d
    rot = 3 * 2 * b * l * h * d if rope else 0
    return fwd + rot, (8 * b * h * l * l * d + rot) if trained else 0


def attention_bytes(b: int, l: int, h: int, d: int, elem: int = 2) -> Tuple[int, int]:
    """(forward, backward) bytes of the DiT's attention entry (RoPE, the
    products, the head merge): forward reads q, k, v and the float32 cos and
    sin tables once and writes the output; backward reads q, k, v, the
    output's gradient and the tables and writes dq, dk, dv."""
    x = b * l * h * d * elem
    tables = 2 * b * l * (d // 2) * 4
    return 4 * x + tables, 7 * x + tables


def attention_least_seconds(b: int, l: int, h: int, d: int) -> float:
    """Least time of one forward and backward of the DiT attention entry."""
    f, bw = attention(b, l, h, d, rope=True)
    bf, bb = attention_bytes(b, l, h, d)
    return least_seconds(f + bw, bf + bb)[0]


# ---------------------------------------------------------------------------
# the whole step, per training row
# ---------------------------------------------------------------------------

def _dit(d: dict, rows: int, l_img: int, l_txt: int, y_grad: bool) -> Tuple[int, int]:
    h, heads = d["hidden_size"], d["num_heads"]
    mh, hd, l = int(h * d["mlp_ratio"]), h // heads, l_img + l_txt
    parts = [linear(rows * l_img, d["in_channels"], h, True, False),
             linear(rows, 256, h, True, False), linear(rows, h, h, True),
             linear(rows, d["vec_in_dim"], h, True, y_grad), linear(rows, h, h, True),
             linear(rows * l_txt, d["context_in_dim"], h, True)]
    if d["guidance_embed"]:
        parts += [linear(rows, 256, h, True, False), linear(rows, h, h, True)]
    for _ in range(d["depth"]):
        for n in (l_img, l_txt):
            parts += [linear(rows, h, 6 * h, True), linear(rows * n, h, 3 * h, True),
                      linear(rows * n, h, h, True), linear(rows * n, h, mh, True),
                      linear(rows * n, mh, h, True)]
        parts.append(attention(rows, l, heads, hd))
    for _ in range(d["depth_single_blocks"]):
        parts += [linear(rows, h, 3 * h, True), linear(rows * l, h, 3 * h + mh, True),
                  linear(rows * l, h + mh, h, True), attention(rows, l, heads, hd)]
    parts += [linear(rows, h, 2 * h, True), linear(rows * l_img, h, d["in_channels"], True)]
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def _vae_encoder(v: dict, rows: int, size: int) -> int:
    ch, mult = v["ch"], list(v["ch_mult"])
    ops, s, cin = conv2d(rows, size, size, v["in_channels"], ch, 3), size, ch
    for i, m in enumerate(mult):
        cout = ch * m
        for _ in range(v["num_res_blocks"]):
            ops += conv2d(rows, s, s, cin, cout, 3) + conv2d(rows, s, s, cout, cout, 3)
            if cin != cout:
                ops += conv2d(rows, s, s, cin, cout, 1)
            cin = cout
        if i != len(mult) - 1:
            s //= 2
            ops += conv2d(rows, s, s, cout, cout, 3)
    c = cin
    res = 2 * conv2d(rows, s, s, c, c, 3)
    ops += 2 * res + 4 * conv2d(rows, s, s, c, c, 1) + attention(rows, s * s, 1, c, False,
                                                               False)[0]
    return ops + conv2d(rows, s, s, c, 2 * v["z_channels"], 3)


def _tower(t: dict, rows: int) -> int:
    h, g = t["hidden_size"], t["image_size"] // t["patch_size"]
    l = g * g + 1
    ops = conv2d(rows, g, g, 3, h, t["patch_size"])
    per_layer = (4 * linear(rows * l, h, h)[0] + linear(rows * l, h, t["intermediate_size"])[0]
                 + linear(rows * l, t["intermediate_size"], h)[0]
                 + attention(rows, l, t["num_heads"], h // t["num_heads"], False, False)[0])
    return ops + t["num_layers"] * per_layer + linear(rows, h, t["projection_dim"])[0]


def step_parts(model: dict, rows: int = 1) -> Dict[str, int]:
    """Operations of ``rows`` training rows by part: ``frozen`` (VAE encode
    and tower forward), ``cond_fwd``/``cond_bwd`` (projectors or adapter),
    ``dit_fwd``/``dit_bwd``."""
    t, d = model["tower"], model["dit"]
    lat = model["img_size"] // 2 ** (len(model["vae"]["ch_mult"]) - 1) // 2
    l_img = lat * lat
    frozen = _vae_encoder(model["vae"], rows, model["img_size"])
    if model["mode"] == "image":
        frozen += _tower(t, rows)
        p = model["projectors"]
        c = [linear(rows, t["projection_dim"], p["clip_dim"], True),
             linear(rows, p["clip_dim"], p["clip_dim"], True),
             linear(rows, t["projection_dim"], p["t5_dim"], True),
             linear(rows, p["t5_dim"], p["t5_dim"], True)]
        l_txt, y_grad = 1, True
    else:
        n = len(model["frame_times"])
        frozen += _tower(t, rows * n)
        g = t["image_size"] // t["patch_size"]
        l_txt, y_grad = n * g * g, False
        c = [linear(rows * l_txt, t["hidden_size"], 2 * t["hidden_size"], True, False),
             linear(rows * l_txt, 2 * t["hidden_size"], model["projectors"]["t5_dim"], True)]
    dit_f, dit_b = _dit(d, rows, l_img, l_txt, y_grad)
    return {"frozen": frozen, "cond_fwd": sum(x[0] for x in c),
            "cond_bwd": sum(x[1] for x in c), "dit_fwd": dit_f, "dit_bwd": dit_b}


def step_ops_per_row(model: dict) -> int:
    """Model operations of one training row of the step."""
    return sum(step_parts(model, 1).values())
