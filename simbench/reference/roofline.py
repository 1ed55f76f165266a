"""The least time the card could take for one ASAS interval's conflict
detection and resolution, from the work its inputs need: the pairs
that pass ``pairs.needed``'s tests, at the tile body's 168 float32
operations a pair, and the interval's inputs read once and outputs
written once.  Peaks: NVIDIA's data sheet for one H100 SXM at 700 W."""

PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12    # HBM3 bytes/s
OPS_PER_PAIR = 168          # the pair geometry, windows and MVP sums

#: bytes of one aircraft's inputs: eight float32 columns (lat, lon, trk,
#: gs, alt, vs, gseast, gsnorth), two flags (active, noreso)
IN_BYTES = 8 * 4 + 2
#: bytes of one aircraft's outputs: the flag and the time to CPA
#: (inconf, tcpamax), six float32 commands (trk, tas, vs, alt, asase,
#: asasn), the resolver's active flag
OUT_BYTES = 1 + 4 + 6 * 4 + 1


def interval_bytes(n: int, k: int) -> int:
    """Bytes an interval of ``n`` aircraft with ``k``-wide partner tables
    needs: inputs and the old table read, outputs and the new table
    written, and the two conflict totals."""
    return n * (IN_BYTES + OUT_BYTES + 2 * 4 * k) + 2 * 4


def least_seconds(pairs: int, n: int, k: int):
    """``(seconds, bound)``: the larger of the operation and the byte
    time, and which one it is."""
    t_ops = pairs * OPS_PER_PAIR / PEAK_F32_FLOPS
    t_bytes = interval_bytes(n, k) / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
