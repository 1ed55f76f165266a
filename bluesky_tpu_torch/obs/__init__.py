"""In-chunk instruments of the port: the ScanStats accumulators
(``scanstats``) and the state fingerprint (``fingerprint``), folded once
per step by the chunk runners of ``core/step.py``."""
