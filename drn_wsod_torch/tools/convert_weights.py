"""Convert Detectron2 (reference) weights into the port's checkpoint
format (counterpart of ``tools/convert_weights.py``, which writes orbax).

    python -m drn_wsod_torch.tools.convert_weights --config-file CONFIG \\
        --weights model_d2.pkl --out output/converted [KEY VALUE ...]

The configured model is built, the weights imported by
``checkpoint/torch_import.py:load_reference_weights`` (a ``.pkl`` or
``.pth`` Detectron2 state dict), and saved with a fresh optimizer state as
step 0 of ``checkpoint/checkpointer.py:Checkpointer`` under ``--out``
(``model_0000000.pth``), which ``Checkpointer.load`` and ``train_net
--resume`` read. Builds on the CUDA device unless ``main`` is given
another one.
"""

from __future__ import annotations

import argparse


def argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="drn_wsod_torch convert_weights")
    p.add_argument("--config-file", required=True)
    p.add_argument("--weights", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def main(argv=None, device=None) -> str:
    """Convert; returns the checkpoint's path."""
    from ..checkpoint import Checkpointer, load_reference_weights
    from ..config import get_cfg
    from ..device import resolve_device
    from ..engine import create_train_state
    from ..models import build_model
    from ..solver import build_optimizer

    args = argument_parser().parse_args(argv)
    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)

    model = build_model(cfg, device=resolve_device(device))
    load_reference_weights(args.weights, model)
    ck = Checkpointer(args.out)
    ck.save(create_train_state(model, build_optimizer(cfg, model)), 0)
    print(f"Converted {args.weights} -> {args.out}")
    return ck.path(0)


if __name__ == "__main__":
    main()
