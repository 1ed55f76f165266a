"""Navigation database: waypoints, navaids, airports, airways, FIRs
(parity: bluesky/navdatabase/).

Loaded from text data in ``settings.navdata_path`` (the standard
fix.dat/nav.dat/airports.dat/awy.dat/fir formats) with a pickled cache,
exposed through dict-indexed O(1) queries instead of the reference's
list.index scans (navdatabase.py:140-351).
"""
from .navdatabase import Navdatabase

_navdb = None


def get_navdb():
    """Process-wide lazy singleton: the database is immutable reference
    data (plus user DEFWPTs), shared by all sims in the process."""
    global _navdb
    if _navdb is None:
        _navdb = Navdatabase()
    return _navdb
