"""Fixed-width column text parser (BADA OPF/APF file format).

Same spec grammar as the reference ``tools/fwparser.py`` (taken from the
BADA manual's fortran-like format lines): each spec line starts with a
line discriminator (e.g. ``CD``) followed by comma-separated fields —
``3X`` skips 3 columns, ``10F`` reads a 10-char float, ``5I`` an int,
``6S`` a string.

Implementation divergence from the reference: the spec is compiled to
explicit (start, end, type) slices instead of a regex assembled from
substitution passes — same accepted inputs, clearer failure modes, and a
``ParseError`` carrying file/line context.

Port of ``bluesky_tpu/models/fwparser.py``: host code, copied as it is.
"""
import re
from typing import List

_FIELD = re.compile(r"\s*(\d+)\s*([XFIS])\s*$", re.IGNORECASE)

_TYPES = {"f": float, "i": int, "s": str}


class ParseError(Exception):
    def __init__(self, fname, lineno):
        super().__init__(f"parse error in {fname}:{lineno}")
        self.fname = fname
        self.lineno = lineno


class FixedWidthParser:
    def __init__(self, specformat: List[str]):
        # Single-line specs repeat for every matching line (fwparser.py:47)
        self.repeat = len(specformat) == 1
        self.lines = []
        for spec in specformat:
            parts = [p.strip() for p in spec.split(",")]
            head = parts[0].split()
            discriminator = head[0]
            rest = head[1:] + parts[1:]
            pos = len(discriminator)
            fields = []   # (start, end, converter)
            for tok in rest:
                if not tok:
                    continue
                m = _FIELD.match(tok)
                if not m:
                    raise ValueError(f"bad field spec {tok!r} in {spec!r}")
                width = int(m.group(1))
                kind = m.group(2).lower()
                if kind != "x":
                    fields.append((pos, pos + width, _TYPES[kind]))
                pos += width
            self.lines.append((discriminator, fields))

    def parse(self, fname: str):
        """Returns a list of per-matched-line value lists."""
        disc, fields = self.lines[0]
        data = []
        with open(fname) as f:
            for lineno, line in enumerate(f):
                if not line.startswith(disc):
                    continue
                try:
                    row = [conv(line[a:b].strip())
                           for a, b, conv in fields]
                except ValueError:
                    raise ParseError(fname, lineno + 1)
                data.append(row)
                if not self.repeat:
                    if len(data) == len(self.lines):
                        break
                    disc, fields = self.lines[len(data)]
        return data
