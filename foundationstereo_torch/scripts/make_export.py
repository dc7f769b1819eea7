"""Export the model at a fixed shape and iteration count.

The port of the JAX package's ``scripts/make_export.py`` (the reference's
``make_onnx.py``), with its flags plus ``--device`` (``cuda`` by default;
``cpu`` to trace and save on the CPU)::

    python -m foundationstereo_torch.scripts.make_export --save_path out/model.pt2 \\
        [--ckpt_dir DIR_OR_PTH] [--height 448 --width 672] [--iters 22] \\
        [--vit_size vits] [--max_disp 192] [--dynamic_batch 1]

The model comes from ``pretrained.from_pretrained`` with ``--ckpt_dir``
(``--vit_size`` and ``--max_disp`` laid over its config, as in the JAX
script), else it has seeded random weights. The program is written by
``inference.export.export_program``, with its kernels in it whether the
batch is fixed or symbolic (``--dynamic_batch 1``); the manifest is printed
and written beside it.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="export the model as a torch.export program")
    ap.add_argument("--save_path", required=True)
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--height", type=int, default=448)
    ap.add_argument("--width", type=int, default=672)
    ap.add_argument("--iters", type=int, default=22)
    ap.add_argument("--vit_size", default="vits")
    ap.add_argument("--max_disp", type=int, default=192)
    ap.add_argument("--dynamic_batch", type=int, default=0,
                    help="1 = symbolic batch dim (the reference make_onnx.py dynamic_axes analog)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from foundationstereo_torch.config import ModelConfig
    from foundationstereo_torch.inference.export import export_program
    from foundationstereo_torch.models.foundation_stereo import FoundationStereo, resolve_device
    from foundationstereo_torch.pretrained import from_pretrained

    device = resolve_device(args.device)
    overrides = {"vit_size": args.vit_size, "max_disp": args.max_disp}
    if args.ckpt_dir:
        model, _ = from_pretrained(args.ckpt_dir, device=device, **overrides)
        print(f"loaded checkpoint {args.ckpt_dir}")
    else:
        model = FoundationStereo(ModelConfig.from_dict(overrides), device=device, seed=0)
    manifest = export_program(model, args.height, args.width, args.iters, args.save_path,
                              dynamic_batch=bool(args.dynamic_batch))
    print(json.dumps(manifest, indent=2))
    return manifest


if __name__ == "__main__":
    main()
