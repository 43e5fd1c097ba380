"""The stage-1 optimizer step in plain float32: the frozen VAE encode and
tower forward, the projectors (image) or the adapter (video), the DiT, the
flow-matching loss, gradient accumulation, the global-norm clip and AdamW.

``follow`` runs the first steps of a run from the same weights, pixels and
random draws as the program and returns what ``compare`` holds the program
to: each step's loss, the first step's clipped gradient norm per leaf, and
the norm of each leaf's change after the last step.

Two values follow the configuration's stated types rather than float32:
the DiT's parameters are stored in the configuration's parameter dtype
(bfloat16 under ``mixed_precision: bf16``: each update is computed in
float32 and the stored value rounded, as GenHancer's trainer stores them),
and the DiT receives its timesteps in the compute dtype, ``1000 t`` taken
in that dtype before the sinusoidal embedding (FLUX's ``timestep_embedding``
on bfloat16 timesteps).  Everything else runs in float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from . import model as M

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def _stored(model: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the parameter's stored dtype, kept as float32."""
    if name.startswith("dit."):
        return x.to(DTYPES[model["dit_param_dtype"]]).to(torch.float32)
    return x


def dit_time_inputs(model: dict, t: torch.Tensor, guidance: float):
    """The values the DiT's two sinusoidal embeddings take: ``1000 t`` and
    ``1000 guidance``, each in the compute dtype."""
    cd = DTYPES[model["compute_dtype"]]
    g = torch.full_like(t, guidance)
    return (t.to(cd) * 1000.0).to(torch.float32), (g.to(cd) * 1000.0).to(torch.float32)


def _micro_inputs(P, model: dict, batch: Dict[str, torch.Tensor], draws, rows):
    """(x1, dit conditioning kwargs) of the rows ``rows`` of one micro-batch,
    the frozen VAE and tower under no_grad."""
    v, t_cfg, dev = model["vae"], model["tower"], P["dit.img_in.weight"].device
    noise = draws["vae_noise"][rows].to(dev, torch.float32)
    with torch.no_grad():
        if model["mode"] == "image":
            px = batch["image"][rows].to(dev, torch.float32)
            x1 = M.pack_latent(M.vae_latent(P, v, px, noise))
            cls, _ = M.tower_forward(P, t_cfg, px)
        else:
            cond = batch["cond"][rows].to(dev, torch.float32)
            x1 = M.pack_latent(M.vae_latent(P, v, batch["target"][rows].to(dev, torch.float32),
                                            noise))
            b, n = cond.shape[:2]
            cls, patches = M.tower_forward(P, t_cfg, cond.reshape((b * n,) + cond.shape[2:]))
            cls, patches = cls.reshape(b, n, -1), patches.reshape(b, n, *patches.shape[1:])
    b = x1.shape[0]
    lat = M.latent_size(model) // 2
    img_ids = M.grid_ids(lat, lat, model.get("target_time", 0.0), dev)[None].expand(b, -1, -1)
    if model["mode"] == "image":
        y = M.projector(P, "clip.project_clip", cls)
        txt = M.projector(P, "clip.project_t5", cls[:, None])
        txt_ids = torch.zeros((b, 1, 3), device=dev)
    else:
        g = t_cfg["image_size"] // t_cfg["patch_size"]
        y = cls.mean(1)
        txt = M.visual_adapter(P, patches.reshape(b, -1, patches.shape[-1]))
        txt_ids = torch.cat([M.grid_ids(g, g, ft, dev) for ft in model["frame_times"]])
        txt_ids = txt_ids[None].expand(b, -1, -1)
    return x1, dict(img_ids=img_ids, txt=txt, txt_ids=txt_ids, y=y)


def micro_loss_backward(P, model: dict, batch, draws, scale: float, row_block: int) -> float:
    """Forward and backward of one micro-batch, its loss times ``scale``,
    in blocks of ``row_block`` rows (each block's squared error over the
    micro-batch's whole count, so the blocks add up to the micro-batch's
    mean); gradients accumulate into the leaves' ``.grad``.  Padded rows
    (``valid`` False) take no part, as their mask takes them out."""
    valid = batch.get("valid")
    rows_all = (torch.nonzero(valid.to(torch.bool)).flatten().tolist() if valid is not None
                else list(range(draws["t"].shape[0])))
    dev = P["dit.img_in.weight"].device
    total = 0.0
    count = None
    for r0 in range(0, len(rows_all), row_block):
        rows = torch.tensor(rows_all[r0:r0 + row_block], dtype=torch.long)
        x1, cond = _micro_inputs(P, model, batch, draws, rows)
        t = draws["t"][rows].to(dev, torch.float32)
        x0 = draws["x0"][rows].to(dev, torch.float32)
        xt = (1 - t[:, None, None]) * x1 + t[:, None, None] * x0
        t_in, g_in = dit_time_inputs(model, t, model["guidance"])
        pred = M.dit_forward(P, model["dit"], xt, cond["img_ids"], cond["txt"],
                             cond["txt_ids"], t_in, cond["y"], g_in)
        err = (pred - (x0 - x1)).square()
        if count is None:
            count = len(rows_all) * err.shape[1] * err.shape[2]
        loss = err.sum() * (scale / count)
        loss.backward()
        total += float(loss.detach())
    return total


class AdamW:
    """Global-norm clip then AdamW (optax's ``clip_by_global_norm`` +
    ``adamw`` order: the learning rate at the count before the step, the
    bias corrections at the count after it), float32 moments."""

    def __init__(self, opt: dict):
        self.lr, self.b1, self.b2 = opt["learning_rate"], opt["adam_beta1"], opt["adam_beta2"]
        self.eps, self.wd, self.clip = opt["adam_epsilon"], opt["adam_weight_decay"], \
            opt["max_grad_norm"]
        self.count = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def clipped(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        if float(norm) < self.clip:
            return grads
        return {k: g / norm * self.clip for k, g in grads.items()}

    @torch.no_grad()
    def update(self, model: dict, P, grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for k, g in grads.items():
            m = self.m.get(k, torch.zeros_like(g)) * self.b1 + (1 - self.b1) * g
            v = self.v.get(k, torch.zeros_like(g)) * self.b2 + (1 - self.b2) * g * g
            self.m[k], self.v[k] = m, v
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps) + self.wd * P[k]
            P[k].copy_(_stored(model, k, P[k] - self.lr * u))


def follow(P: Dict[str, torch.Tensor], model: dict, opt: dict,
           steps: Sequence[List[dict]], draws: Sequence[List[dict]], row_block: int,
           samples: Dict[str, torch.Tensor]) -> dict:
    """Run ``len(steps)`` optimizer steps of ``accum`` micro-batches each
    (``steps[s][i]`` the host batch, ``draws[s][i]`` its draws) on the
    float32 parameters ``P`` (updated in place) and return ``{"loss": [per
    step], "grad_norm": {leaf: norm of step 1's clipped gradient},
    "update_norm": {leaf: norm of p_last - p_0}, "grad_sample": {leaf: step
    1's clipped gradient at the flat indices samples[leaf]}}``."""
    M.set_precision()
    names = [k for k in P if M.trainable(model, k)]
    for k in names:
        P[k].requires_grad_(True)
    start = {k: P[k].detach().clone() for k in names}
    adam = AdamW(opt)
    losses, grad_norm = [], None
    for micro_batches, micro_draws in zip(steps, draws):
        loss = 0.0
        for batch, dr in zip(micro_batches, micro_draws):
            loss += micro_loss_backward(P, model, batch, dr, 1.0 / len(micro_batches),
                                        row_block)
        grads = {}
        for k in names:
            g = P[k].grad
            grads[k] = g if g is not None else torch.zeros_like(P[k])
            P[k].grad = None
        grads = adam.clipped(grads)
        if grad_norm is None:
            grad_norm = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
            grad_sample = {k: g.reshape(-1)[samples[k].to(g.device)].cpu()
                           for k, g in grads.items()}
        adam.update(model, P, grads)
        losses.append(loss)
        del grads
    update_norm = {k: float(torch.linalg.vector_norm(P[k].detach() - start[k])) for k in names}
    for k in names:
        P[k].requires_grad_(False)
    if not all(math.isfinite(x) for x in losses):
        losses = [float("nan")] * len(losses)
    return {"loss": losses, "grad_norm": grad_norm, "update_norm": update_norm,
            "grad_sample": grad_sample}
