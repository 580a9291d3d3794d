"""Utility surface (counterpart of convnets_tpu/utils.py, the reference's
UtilityMngr, mngrutility.py:13-114).

split():                  chunk an array into fixed-size parts (the
                          test-time subsampling helper).
set_reproducible_mode():  seed the host RNGs (random, numpy) as the JAX
                          package does, and torch's default generators.
get_models_scores():      cross-model score loader for the comparison plots:
                          scans an output directory for each architecture's
                          newest checkpoint and tests it.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence

from convnets_tpu_torch.core import rng


def split(array, part_size: int) -> List:
    """Split into consecutive chunks of part_size (the last may be shorter)."""
    array = list(array)
    part_size = max(int(part_size), 1)
    return [array[i:i + part_size] for i in range(0, len(array), part_size)]


def set_reproducible_mode(seed: int = 21, deterministic: bool = True) -> None:
    """Pin the host RNGs and torch's default generators
    (core.set_reproducible_mode, with the JAX utils' defaults)."""
    rng.set_reproducible_mode(seed, deterministic)


def get_models_scores(
    output_dir: str = os.path.join("data", "output"),
    archs: Optional[Sequence[str]] = None,
    make_loader=None,
    device="cuda",
) -> Dict[str, List[float]]:
    """Test each architecture's newest checkpoint in `output_dir` on its
    test set, on `device`.

    make_loader(setting) -> test loader; defaults to DataMngr.load_test.
    Returns {model_name: subset-accuracy samples} for PlotMngr.models().
    The newest is the highest version per model name; a version that has
    several checkpoint kinds resolves best > tuned > last, never by the
    directory's listing order."""
    from convnets_tpu_torch.data.manager import DataMngr
    from convnets_tpu_torch.models import available_models, build_model
    from convnets_tpu_torch.settings import Settings
    from convnets_tpu_torch.train import checkpoint as ckpt
    from convnets_tpu_torch.train.engine import Trainer

    pat = re.compile(r"^(.+)-(\d+)-(\w+)" + re.escape(ckpt.EXT) + "$")
    kind_rank = {ckpt.SUFFIX_BEST_SCORE: 3, ckpt.SUFFIX_BEST_LOSS: 3,
                 ckpt.SUFFIX_TUNED: 2}
    latest: Dict[str, tuple] = {}
    if os.path.isdir(output_dir):
        for fname in os.listdir(output_dir):
            m = pat.match(fname)
            if m:
                name, version, kind = m.group(1), int(m.group(2)), m.group(3)
                key = (version, kind_rank.get(kind, 1))
                if name not in latest or key > latest[name][0]:
                    latest[name] = (key, os.path.join(output_dir, fname))

    wanted = set(archs or available_models())
    scores: Dict[str, List[float]] = {}
    for model_name, (_, found) in sorted(latest.items()):
        _, meta = ckpt.load_checkpoint(found)
        sd = meta["settings"]
        arch = meta.get("extra", {}).get("arch")
        if arch is None:  # a checkpoint without its arch: match it by model name
            flat = model_name.lower()
            cands = [a for a in available_models() if flat.startswith(a.replace("_", ""))]
            arch = max(cands, key=len) if cands else None
        if arch is None or arch not in wanted:
            continue
        setting = Settings(kind=sd["kind"], input_size=sd["input_size"],
                           num_classes=sd["num_classes"])
        setting.load_values({k: v for k, v in sd.items()
                             if k in setting.get_hparams_names()})
        setting.output_dir = output_dir
        model = build_model(arch, setting, device=device)
        trainer = Trainer(model)
        trainer.load_checkpoint(found)
        loader = (make_loader(setting) if make_loader
                  else DataMngr(setting, device=device).load_test())
        subset_scores, _, _ = trainer.test(loader)
        scores[model.model_name] = [float(s) for s in subset_scores]
    return scores
