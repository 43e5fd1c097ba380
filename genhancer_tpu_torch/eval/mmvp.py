"""MMVP-VLM pairwise evaluation of a CLIP-family or SigLIP tower.

Port of ``genhancer_tpu/eval/mmvp.py`` (protocol parity with the
reference's ``evaluation/evaluate_mmvp_*.py``):

  * ``Questions.csv`` rows consumed in consecutive pairs; images at
    ``MLLM_VLM Images/{category}/{qid}.jpg``; prompt = ``'a photo of ' +
    statement``;
  * every image and text embedded in batches of 50 (float32, on the tower's
    device, TF32 off), then per text ``softmax(logits_per_text)`` over
    [img1, img2] (SigLIP's ``logit_bias`` added to the logits): pred = img1
    iff p > 0.5; GT img1 iff qid odd; a pair scores only if both texts are
    right;
  * per-category % + ``average_score``; the raw rows optionally written to
    a CSV.

The pairwise scoring runs in NumPy on the host, line for line as in JAX, so
the embeddings are the only thing the two packages can differ in.  The
tokenizer is an injectable ``texts -> (ids, mask | None)``;
``default_tokenizer`` builds one from a local model directory with
``transformers`` (77 tokens for CLIP, 64 for SigLIP, no mask).  SigLIP
images are resized straight to (size, size), CLIP's resized on the short
edge and center-cropped (``mmvp.py:78-90``).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.transforms import decode_image, resize_center_crop, to_float01
from ..models.towers import clip as clip_m
from ..models.towers import siglip as siglip_m
from ..tasks.conditioning import normalize, tower_stats

CATEGORIES = [
    "Orientation and Direction", "Presence of Specific Features",
    "State and Condition", "Quantity and Count",
    "Positional and Relational Context", "Color and Appearance",
    "Structural Characteristics", "Texts",
    "Viewpoint and Perspective",
]


@dataclass
class Pair:
    qid1: int
    qid2: int
    category: str
    text1: str
    text2: str
    img1: str
    img2: str


def load_pairs(benchmark_dir: str) -> List[Pair]:
    image_dir = os.path.join(benchmark_dir, "MLLM_VLM Images")
    csv_file = os.path.join(benchmark_dir, "Questions.csv")
    pairs: List[Pair] = []
    with open(csv_file) as f:
        reader = csv.reader(f)
        next(reader)  # header
        rows = list(reader)
    for i in range(0, len(rows) - 1, 2):
        qid1, qtype1, stmt1 = rows[i][:3]
        qid2, qtype2, stmt2 = rows[i + 1][:3]
        pairs.append(Pair(
            qid1=int(qid1), qid2=int(qid2), category=qtype1,
            text1="a photo of " + stmt1, text2="a photo of " + stmt2,
            img1=os.path.join(image_dir, qtype1, f"{int(qid1)}.jpg"),
            img2=os.path.join(image_dir, qtype1, f"{int(qid2)}.jpg")))
    return pairs


def preprocess_image(path: str, kind: str, image_size: int) -> np.ndarray:
    """The HF processors' semantics: ``CLIPImageProcessor`` a shortest-edge
    bicubic resize and a center crop, ``SiglipImageProcessor`` a bicubic
    resize straight to (size, size); then rescale and the tower's mean/std
    (float32, HWC)."""
    mean, std = tower_stats(kind)
    with open(path, "rb") as f:
        img = decode_image(f.read())
    if kind == "siglip":
        from PIL import Image
        img = img.resize((image_size, image_size), Image.BICUBIC)
    else:
        img = resize_center_crop(img, image_size)
    return normalize(torch.from_numpy(to_float01(img)), mean, std).numpy()


def default_tokenizer(model_dir: str, kind: str) -> Callable:
    """The HF tokenizer of ``model_dir``: texts -> (ids [N, 77] for CLIP,
    [N, 64] for SigLIP, padded to that length; None: the reference passes no
    attention mask)."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            "the default MMVP-VLM tokenizer needs the transformers package, which is not "
            "installed; pass evaluate() a tokenize function instead") from e
    tok = AutoTokenizer.from_pretrained(model_dir)
    length = 64 if kind == "siglip" else 77

    def fn(texts):
        out = tok(texts, padding="max_length", truncation=True, max_length=length,
                  return_tensors="np")
        return out["input_ids"], None
    return fn


@torch.no_grad()
def _embed_all(model, cfg, kind: str, images: np.ndarray, input_ids: np.ndarray,
               batch: int = 50):
    """Batched float32 image and text embeddings on the tower's device."""
    mod = siglip_m if kind == "siglip" else clip_m
    dev = model.logit_scale.device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    img_out, txt_out = [], []
    for i in range(0, len(images), batch):
        x = torch.from_numpy(np.ascontiguousarray(images[i:i + batch])).to(dev)
        img_out.append(mod.get_image_features(model, x, cfg).float().cpu().numpy())
    for i in range(0, len(input_ids), batch):
        ids = torch.from_numpy(np.ascontiguousarray(input_ids[i:i + batch])).to(dev)
        txt_out.append(mod.get_text_features(model, ids, cfg).float().cpu().numpy())
    return np.concatenate(img_out), np.concatenate(txt_out)


def evaluate(model, cfg, kind: str, benchmark_dir: str,
             tokenize: Callable, image_size: Optional[int] = None,
             results_csv: Optional[str] = None, batch: int = 50) -> Dict[str, float]:
    """Run the full benchmark on ``model`` (a ``CLIPModel`` or
    ``SiglipModel``); returns {category: pct, 'average_score': pct}."""
    pairs = load_pairs(benchmark_dir)
    image_size = image_size or cfg.vision.image_size

    images = np.stack([preprocess_image(p, kind, image_size)
                       for pair in pairs for p in (pair.img1, pair.img2)])
    texts = [t for pair in pairs for t in (pair.text1, pair.text2)]
    input_ids, _ = tokenize(texts)

    img_emb, txt_emb = _embed_all(model, cfg, kind, images, np.asarray(input_ids), batch)
    img_emb = img_emb / np.linalg.norm(img_emb, axis=-1, keepdims=True)
    txt_emb = txt_emb / np.linalg.norm(txt_emb, axis=-1, keepdims=True)
    scale = float(np.exp(model.logit_scale.detach().float().cpu().numpy().reshape(())))
    bias = getattr(model, "logit_bias", None)       # SigLIP's; CLIP has none
    bias = 0.0 if bias is None else float(bias.detach().float().cpu().numpy().reshape(()))

    cat_correct: Dict[str, int] = {}
    cat_total: Dict[str, int] = {}
    rows = []
    for i, pair in enumerate(pairs):
        ims = img_emb[2 * i: 2 * i + 2]          # [2, d]
        preds, scores = [], []
        for j, txt in enumerate(txt_emb[2 * i: 2 * i + 2]):
            logits = scale * (txt @ ims.T) + bias
            p = np.exp(logits - logits.max())
            p = p / p.sum()
            scores.append(float(p[0]))
            preds.append("img1" if p[0] > 0.5 else "img2")
        gts = ["img1" if pair.qid1 % 2 == 1 else "img2",
               "img1" if pair.qid2 % 2 == 1 else "img2"]
        ok = preds[0] == gts[0] and preds[1] == gts[1]
        cat_correct[pair.category] = cat_correct.get(pair.category, 0) + int(ok)
        cat_total[pair.category] = cat_total.get(pair.category, 0) + 1
        rows.append([pair.qid1, pair.qid2, preds[0], preds[1], gts[0], gts[1],
                     scores[0], scores[1]])

    if results_csv:
        with open(results_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["qid1", "qid2", "pred1", "pred2", "gt1", "gt2",
                        "q1score", "q2score"])
            w.writerows(rows)

    out = {c: 100.0 * cat_correct[c] / cat_total[c] for c in cat_correct}
    out["average_score"] = float(np.mean(list(out.values())))
    return out


def evaluate_model_dir(model_dir: str, benchmark_dir: str, tower: str = "openai_clip",
                       clip_image_size: int = 224, clip_type: Optional[str] = None,
                       base_model_dir: Optional[str] = None,
                       results_csv: Optional[str] = None,
                       device="cuda") -> Dict[str, float]:
    """Load an (exported) HF tower directory onto ``device`` and evaluate it —
    the step after stage-2 training.  ``base_model_dir`` supplies the
    tokenizer files where the export lacks them; images are preprocessed at
    the loaded tower's resolution."""
    from .. import registry
    from ..serve.engine import resolve_device
    if not os.path.isdir(model_dir):
        raise FileNotFoundError(
            f"model_dir {model_dir!r} does not exist — evaluating a random-init "
            "tower would silently report garbage accuracy")
    kind, cfg = registry.tower_family_and_config(tower, clip_image_size, clip_type)
    model, cfg = registry.load_tower(kind, cfg, model_dir, device=resolve_device(device))
    tokenize = default_tokenizer(base_model_dir or model_dir, kind)
    return evaluate(model, cfg, kind, benchmark_dir, tokenize,
                    image_size=cfg.vision.image_size, results_csv=results_csv)
