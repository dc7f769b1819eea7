"""Weight bridge: the JAX package's variables -> the port's ``state_dict``.

Input is the flat dict ``{"params::a/b/c": array, "batch_stats::a/b/c": array}``
(flax paths joined by ``/``), numpy arrays or anything ``np.asarray`` takes.
The port's parameter names are the reference's torch names, so the output
also loads a reference checkpoint's layout and the JAX package's own
importer maps it back.
"""

from __future__ import annotations

import numpy as np
import torch

from foundationstereo_torch.convert.name_map import build_name_map, canonical_path


def _to_torch_layout(tf: str, x: np.ndarray) -> np.ndarray:
    """Inverse of the named flax <- torch transform."""
    if tf == "conv":        # (*k, I, O) -> (O, I, *k)
        n = x.ndim - 2
        return np.transpose(x, (n + 1, n) + tuple(range(n)))
    if tf == "deconv":      # (*k, I, O) -> (I, O, *k)
        n = x.ndim - 2
        return np.transpose(x, (n, n + 1) + tuple(range(n)))
    if tf == "linear":      # (I, O) -> (O, I)
        return x.T
    if tf == "dense1x1":    # (I, O) -> (O, I, 1, 1)
        return x.T[..., None, None]
    if tf == "ident":
        return x
    raise ValueError(tf)


def flatten_variables(variables) -> dict[str, np.ndarray]:
    """Nested flax variables {"params": {...}, "batch_stats": {...}} ->
    {"params::a/b": array, "batch_stats::a/b": array}."""
    flat = {}

    def walk(tree, prefix):
        if isinstance(tree, dict) or hasattr(tree, "items"):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}/")
        else:
            flat[prefix[:-1]] = np.asarray(tree)

    for coll in ("params", "batch_stats"):
        if coll in variables:
            walk(variables[coll], f"{coll}::")
    return flat


def jax_to_state_dict(flat: dict[str, np.ndarray], cfg) -> tuple[dict[str, torch.Tensor], list[str]]:
    """Map flat JAX variables onto reference-named torch tensors.

    Returns (state_dict, unmapped) where ``unmapped`` lists the JAX leaves no
    rule covers.
    """
    rules = build_name_map(cfg).rules
    out, unmapped = {}, []
    for key, leaf in flat.items():
        coll, path = key.split("::", 1)
        prefix = "batch_stats::" if coll == "batch_stats" else ""
        rule = next((rules[c] for c in (prefix + path, prefix + canonical_path(path))
                     if c in rules), None)
        if rule is None:
            unmapped.append(key)
            continue
        tk, tf = rule
        out[tk] = torch.from_numpy(np.array(
            _to_torch_layout(tf, np.asarray(leaf, np.float32)), order="C"))
    return out, unmapped


def load_jax_variables(model: torch.nn.Module, variables, cfg=None,
                       flax_prefix: str = "", torch_prefix: str = "") -> None:
    """Load nested JAX variables {"params": ..., "batch_stats": ...} into the
    port's model, or into one of its submodules: then the JAX variables are
    rooted at that module, which sits at ``flax_prefix`` in the JAX tree and
    ``torch_prefix`` in the port's. Raises unless every JAX leaf and every
    module entry is covered, with matching shapes."""
    flat = flatten_variables(variables)
    if flax_prefix:
        flat = {k.replace("::", f"::{flax_prefix}/", 1): v for k, v in flat.items()}
    sd, unmapped = jax_to_state_dict(flat, cfg if cfg is not None else model.cfg)
    if torch_prefix:
        sd = {k[len(torch_prefix) + 1:]: v for k, v in sd.items()}
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    bad = [k for k in sd if k in own and tuple(sd[k].shape) != tuple(own[k].shape)]
    if unmapped or missing or extra or bad:
        raise ValueError(f"bridge mismatch: unmapped JAX leaves {unmapped[:5]}, "
                         f"model keys without a JAX leaf {missing[:5]}, "
                         f"keys the model lacks {extra[:5]}, shape mismatches {bad[:5]}")
    model.load_state_dict(sd)
