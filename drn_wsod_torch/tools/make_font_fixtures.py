"""Write the glyph table the port's visualizer draws its labels with
(``drn_wsod_torch/utils/font_table.json``):

    python -m drn_wsod_torch.tools.make_font_fixtures

The JAX package's ``Visualizer`` writes its labels with Pillow's default
font, ``ImageFont.load_default()``: in Pillow 12 the FreeType face
"Aileron Regular" (CC0, shipped inside Pillow) at size 10, antialiased,
laid out by Pillow's basic engine. For each printable ASCII character the
table holds the coverage mask that ``font.getmask2(ch, "L")`` renders at
an integral origin (rows of hex bytes), its offset from the text origin
and its advance, plus the kerning of every pair whose ``getlength``
differs from the sum of the advances (none for this face). The advances
are whole pixels, so a label drawn at an integral origin is these masks
placed at the summed advances and merged as Pillow merges overlapping
glyphs (``utils/visualizer.py:render_text``).

``tests/test_torch_visualizer.py`` holds the committed table to a fresh
build (so a stale table shows) and the port's labels to Pillow's. Needs
Pillow.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

TABLE = Path(__file__).resolve().parents[1] / "utils" / "font_table.json"
CHARS = [chr(c) for c in range(32, 127)]


def build_table() -> dict:
    """The table as a dict (Pillow's default font, rendered here)."""
    import PIL
    from PIL import ImageFont

    font = ImageFont.load_default()
    glyphs = {}
    for ch in CHARS:
        mask, offset = font.getmask2(ch, "L")
        w, h = mask.size
        a = np.array(mask, np.uint8).reshape(h, w) if w * h else \
            np.zeros((h, w), np.uint8)
        advance = font.getlength(ch)
        if advance != int(advance):
            raise ValueError(f"{ch!r} advances by {advance}: the table "
                             "takes whole-pixel advances only")
        glyphs[str(ord(ch))] = {
            "advance": int(advance), "offset": [int(offset[0]),
                                                int(offset[1])],
            "rows": [row.tobytes().hex() for row in a], "width": int(w)}
    kerning = {}
    for a in CHARS:
        for b in CHARS:
            k = font.getlength(a + b) - font.getlength(a) - font.getlength(b)
            if k:
                kerning[f"{ord(a)},{ord(b)}"] = k
    return {"font": f"{font.getname()[0]} {font.getname()[1]} {font.size}, "
                    f"Pillow {PIL.__version__} ImageFont.load_default()",
            "glyphs": glyphs, "kerning": kerning}


def main(argv=None) -> Path:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]) \
        .parse_args(argv)
    table = build_table()
    TABLE.write_text(json.dumps(table, indent=0, sort_keys=True) + "\n")
    print(f"wrote {TABLE} ({len(table['glyphs'])} glyphs)")
    return TABLE


if __name__ == "__main__":
    main()
