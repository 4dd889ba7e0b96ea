"""Convert a torch ColorVideoVDP-ML checkpoint (cvvdp.ckpt, Lightning-style
state_dict) into the cvvdp_ml.npz that ``metrics/ml.py`` reads
(counterpart of the JAX package's ``tools/convert_ml_ckpt.py``, kept as a
copy of its own with the manifest beside it).

Usage:
    python -m colorvideovdp_tpu_torch.tools.convert_ml_ckpt /path/to/cvvdp.ckpt [out.npz]

    # validate a converted npz against the published checkpoint layout
    # (cvvdp_ml_manifest.json beside this file: exact key set and shapes
    # per family), optionally against one named family:
    python -m colorvideovdp_tpu_torch.tools.convert_ml_ckpt --validate out.npz [family]

The published checkpoints are at huggingface.co/gfxdisp/cvvdp_ml. Run the
converter wherever that download is possible and put the npz on a config
path (next to a cvvdp_parameters.json, or a ``config_paths`` directory).
Conversion validates against the manifest when the key set matches a known
family, and warns otherwise.

The checkpoint is read with ``torch.load(path, map_location="cpu")`` and
torch's own default for ``weights_only``, as the JAX package's tool reads
it: under torch 2.6 and later that default is ``weights_only=True``, which
refuses a checkpoint that pickles objects other than tensors, plain
containers and numbers (a Lightning checkpoint with hyper-parameters held
as custom classes, for example). Such a file loads in neither tool on that
torch.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cvvdp_ml_manifest.json")


def load_manifest():
    with open(MANIFEST) as f:
        return json.load(f)


def identify_family(keys, manifest):
    """The metric family whose manifest key set exactly matches, if any."""
    ks = set(keys)
    for fam, spec in sorted(manifest.items(), key=lambda kv: -len(kv[1])):
        if ks == set(spec):
            return fam
    return None


def validate(arrays, family=None):
    """Check {key: array} against the manifest. Returns the family name.
    Raises ValueError with the full mismatch list on any difference."""
    manifest = load_manifest()
    if family is None:
        family = identify_family(arrays.keys(), manifest)
        if family is None:
            # No exact match: report against the closest family.
            family = max(manifest, key=lambda f: len(set(manifest[f]) & set(arrays)))
    spec = manifest[family]
    problems = []
    for k in sorted(set(spec) - set(arrays)):
        problems.append(f"missing key: {k} (expected shape {spec[k]})")
    for k in sorted(set(arrays) - set(spec)):
        problems.append(f"unexpected key: {k}")
    for k in sorted(set(spec) & set(arrays)):
        if list(arrays[k].shape) != spec[k]:
            problems.append(f"shape mismatch: {k} is {list(arrays[k].shape)}, "
                            f"manifest says {spec[k]}")
    if problems:
        raise ValueError(f"npz does not match the '{family}' checkpoint layout:\n  "
                         + "\n  ".join(problems))
    return family


def convert(ckpt_path: str, out_path: str):
    """Write every tensor of the checkpoint's state_dict (or of the file, if
    it has none) to ``out_path`` as float32 arrays under their keys."""
    import torch

    state = torch.load(ckpt_path, map_location="cpu")
    if "state_dict" in state:
        state = state["state_dict"]
    arrays = {}
    for key, val in state.items():
        if hasattr(val, "detach"):
            arrays[key] = val.detach().cpu().numpy().astype(np.float32)
    np.savez_compressed(out_path, **arrays)
    print(f"Wrote {len(arrays)} tensors to {out_path}")
    try:
        fam = validate(arrays)
        print(f"Layout matches the '{fam}' manifest (sha256 {_sha256(out_path)})")
    except ValueError as e:
        print(f"WARNING: {e}", file=sys.stderr)


def _sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--validate":
        npz = argv[1]
        family = argv[2] if len(argv) > 2 else None
        with np.load(npz) as z:
            arrays = {k: z[k] for k in z.files}
        fam = validate(arrays, family)
        print(f"{npz}: valid '{fam}' layout, {len(arrays)} tensors, sha256 {_sha256(npz)}")
        return
    ckpt = argv[0]
    out = argv[1] if len(argv) > 1 else "cvvdp_ml.npz"
    convert(ckpt, out)


if __name__ == "__main__":
    main()
