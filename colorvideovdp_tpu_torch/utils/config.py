"""Configuration-file resolution and JSON helpers.

Same search order as ``colorvideovdp_tpu.utils.config``: explicit
``config_paths`` (file prefix match, then directories) -> ``$CVVDP_PATH`` ->
the calibration directory of the JAX package, read in place by file path
(the JAX package itself is never imported: it imports jax).
"""

from __future__ import annotations

import json
import os

VVDP_DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "colorvideovdp_tpu",
    "vvdp_data",
)


def json2dict(path: str) -> dict:
    if not os.path.isfile(path):
        raise RuntimeError(f"Error: Cannot find file {path}")
    with open(path, "r") as f:
        return json.load(f)


class config_files:
    """Resolver for metric/display/CSF configuration files."""

    @classmethod
    def find(cls, fname: str, config_paths: list | None = None) -> str:
        config_paths = config_paths or []
        if not isinstance(config_paths, list):
            raise RuntimeError("config_paths must be a list")

        bname, ext = os.path.splitext(fname)
        for cp in config_paths:
            if not (os.path.isfile(cp) or os.path.isdir(cp)):
                raise RuntimeError(f"config_path '{cp}' does not exist")
            if (
                os.path.isfile(cp)
                and os.path.basename(cp).startswith(bname)
                and os.path.basename(cp).endswith(ext)
            ):
                return cp

        for cp in config_paths:
            if os.path.isdir(cp):
                path = os.path.join(cp, fname)
                if os.path.isfile(path):
                    return path

        env_dir = os.getenv("CVVDP_PATH")
        if env_dir is not None:
            path = os.path.join(env_dir, fname)
            if os.path.isfile(path):
                return path

        path = os.path.join(VVDP_DATA, fname)
        if os.path.isfile(path):
            return path

        raise RuntimeError(f"The configuration file {fname} not found")


def write_parameters(directory: str, **overrides) -> list:
    """Write the default ``cvvdp_parameters.json`` with ``overrides`` (for
    example ``contrast="log"`` or ``masking_model="mult-transducer"``) into
    ``directory``, created if needed, and return ``[directory]``: the
    ``config_paths`` that scores with that configuration."""
    params = json2dict(os.path.join(VVDP_DATA, "cvvdp_parameters.json"))
    params.update(overrides)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "cvvdp_parameters.json"), "w") as f:
        json.dump(params, f, indent=4)
    return [directory]
