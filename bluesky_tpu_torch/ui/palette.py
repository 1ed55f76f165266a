"""Colour palette registry (reference ui/palette.py).

Port of ``bluesky_tpu/ui/palette.py``: host code, copied unchanged.

The reference ``exec()``s an arbitrary Python palette file into module
globals (palette.py:8-15) — arbitrary code execution for a colour table.
Here a palette file is plain ``name = (r, g, b)`` lines parsed with
``ast.literal_eval`` (data, not code), and defaults are registered
per-module via ``set_default_colours`` exactly like the reference
(palette.py:18-30) so every colour consumer declares what it needs.
"""
import ast
import os
from typing import Dict, Tuple

Colour = Tuple[int, int, int]

_colours: Dict[str, Colour] = {}


def set_default_colours(**kwargs):
    """Register default colour values; the loaded palette wins
    (reference palette.py:18-30)."""
    for key, value in kwargs.items():
        _colours.setdefault(key, tuple(value))


def get(name: str, default: Colour = (255, 255, 255)) -> Colour:
    return _colours.get(name, default)


def __getattr__(name: str):
    # palette.aircraft etc., mirroring the reference's module-global style
    if name.startswith("_"):
        raise AttributeError(name)
    try:
        return _colours[name]
    except KeyError:
        raise AttributeError(f"no colour {name!r} in palette") from None


def load(pfile: str) -> bool:
    """Load ``name = (r, g, b)`` assignments from a palette file."""
    if not os.path.isfile(pfile):
        return False
    with open(pfile) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, _, val = line.partition("=")
            try:
                rgb = ast.literal_eval(val.strip())
            except (ValueError, SyntaxError):
                continue
            if (isinstance(rgb, tuple) and len(rgb) == 3
                    and all(isinstance(c, int) for c in rgb)):
                _colours[key.strip()] = rgb
    return True


# Default radar colours (reference data/graphics/palettes/bluesky-default)
set_default_colours(
    aircraft=(0, 255, 0),
    conflict=(255, 160, 0),
    route=(255, 0, 255),
    trails=(0, 255, 255),
    aptlabel=(220, 250, 255),
    wptlabel=(220, 250, 255),
    polys=(0, 0, 255),
    previewpoly=(0, 204, 255),
    coastlines=(85, 85, 115),
    background=(0, 0, 0),
)
