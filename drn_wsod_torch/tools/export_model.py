"""Export a model's inference forward through ``torch.export``
(counterpart of ``tools/export_model.py``, which writes a ``jax.export``
StableHLO program).

    python -m drn_wsod_torch.tools.export_model --config-file CONFIG \\
        --output model.pt2 [--height 512 --width 512 --proposals 2048] \\
        [--run-check] [KEY VALUE ...]

The example batch is ``synthetic.synthetic_batch`` at B = 1 and the given
shape; the program is shape-specialised to it (``export.py``), so pick the
padded bucket the serving path uses. The weights are zeros, then
``MODEL.WEIGHTS`` (Detectron2 weights, ``checkpoint/torch_import.py``)
where set, as in the JAX tool. ``--run-check`` loads the artifact back and
holds its output to the live model's at rtol = atol = 1e-5. Runs on the
CUDA device unless ``main`` is given another one.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="drn_wsod_torch export")
    p.add_argument("--config-file", required=True)
    p.add_argument("--output", required=True,
                   help="path for the serialised torch.export program")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--proposals", type=int, default=2048,
                   help="padded proposal-slot count of the serving bucket")
    p.add_argument("--run-check", action="store_true",
                   help="load the artifact and compare its output against "
                        "the live model on the example batch")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def main(argv=None, device=None) -> bytes:
    """Export, write ``--output``, optionally check; returns the bytes."""
    from ..checkpoint import load_reference_weights
    from ..config import get_cfg
    from ..export import export_inference, load_exported
    from ..models import build_model
    from ..synthetic import synthetic_batch

    args = argument_parser().parse_args(argv)
    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)

    model = build_model(cfg, device=device)
    dev = next(model.parameters()).device
    batch = synthetic_batch(B=1, H=args.height, W=args.width,
                            P=args.proposals,
                            C=cfg.MODEL.ROI_HEADS.NUM_CLASSES, device=dev)
    with torch.no_grad():
        for t in model.state_dict().values():
            t.zero_()
    if cfg.MODEL.WEIGHTS:
        load_reference_weights(cfg.MODEL.WEIGHTS, model)

    data = export_inference(model, batch, path=args.output)
    print(f"wrote {args.output} ({len(data)} bytes)")

    if args.run_check:
        got = load_exported(args.output).call(batch)
        want = model.inference_scores(batch)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.float().cpu().numpy(),
                                       w.float().cpu().numpy(),
                                       rtol=1e-5, atol=1e-5)
        print("run-check OK: exported program matches the live model")
    return data


if __name__ == "__main__":
    main()
