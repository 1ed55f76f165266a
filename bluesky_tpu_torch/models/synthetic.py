"""Synthetic performance data in the exact BADA and BS file formats.

No BS XML database and no BADA data ship with the repository (BADA is
proprietary), so the parsers of ``models/coeff_bada.py`` and
``models/coeff_bs.py`` are exercised on files written here:

* ``write_bada_dir(path)`` writes ``A320__.OPF``, ``A320__.APF`` and a
  ``SYNONYM.NEW`` in BADA 3's fixed-width layout (the OPF and APF lines
  are the JAX package's own synthetic A320, ``tests/test_perf_models.py``
  ``_opf_lines``/``_apf_lines``);
* ``write_bs_dir(path)`` writes ``aircraft/*.xml`` and ``engines/*.xml``
  in the structure ``coeff_bs.load_bs_dir`` reads: a twin jet, a
  four-engine jet and a turboprop, with the unit attributes and the
  zero-valued fields that take the loader's fallbacks.

``write_perf_tree(root)`` writes both as ``<root>/BADA`` and
``<root>/BS``: point ``settings.perf_path`` at ``root`` and set
``settings.performance_model`` to ``"bada"`` or ``"bs"``.  The values
are plausible, not any real aircraft's.
"""
import os

#: the types the files define, by model
BADA_TYPES = ("A320",)
BS_TYPES = ("A320", "B744", "AT72")


def _f10(x):
    return f"{x:10.5G}"


def opf_lines():
    """A synthetic A320-ish OPF in the exact BADA fixed-width layout."""
    pad = " "
    L = []
    L.append(f"CD {pad:2}A320__{pad:9}2{pad:12}Jet{pad:6}{pad:17}M")
    L.append("CD  " + "   " + _f10(64.0) + "   " + _f10(39.0) + "   "
             + _f10(77.0) + "   " + _f10(21.5) + "   " + _f10(0.2))
    L.append("CD  " + "   " + _f10(350.0) + "   " + _f10(0.82) + "   "
             + _f10(41000.0) + "   " + _f10(38000.0) + "   "
             + _f10(-121.0))
    L.append("CD  " + "   " + _f10(122.6) + "   " + _f10(1.4) + "   "
             + _f10(13.2) + "   " + _f10(0.0))
    for vstall, cd0, cd2 in [(145.0, 0.024, 0.0375),   # CR
                             (117.0, 0.023, 0.0414),   # IC
                             (114.0, 0.038, 0.0412),   # TO
                             (108.0, 0.042, 0.0424),   # AP
                             (101.0, 0.076, 0.0413)]:  # LD
        L.append("CD" + " " * 15 + "   " + _f10(vstall) + "   "
                 + _f10(cd0) + "   " + _f10(cd2))
    L += ["CD" + " " * 50] * 3
    L.append("CD" + " " * 31 + _f10(0.0288))
    L += ["CD" + " " * 50] * 2
    L.append("CD  " + "   " + _f10(136000.0) + "   " + _f10(52238.0)
             + "   " + _f10(2.67e-11) + "   " + _f10(10.8) + "   "
             + _f10(0.0107))
    L.append("CD  " + "   " + _f10(0.0297) + "   " + _f10(0.955) + "   "
             + _f10(8000.0) + "   " + _f10(0.122) + "   " + _f10(0.288))
    L.append("CD  " + "   " + _f10(300.0) + "   " + _f10(0.78))
    L.append("CD  " + "   " + _f10(0.697) + "   " + _f10(1068.0))
    L.append("CD  " + "   " + _f10(12.9) + "   " + _f10(64430.0))
    L.append("CD" + " " * 5 + _f10(0.92958))
    L.append("CD  " + "   " + _f10(2190.0) + "   " + _f10(1440.0)
             + "   " + _f10(34.1) + "   " + _f10(37.57))
    return L


def apf_lines():
    """The matching APF: low/average/high reference speed profiles."""
    def prof(v1, v2, m):
        return ("CD" + " " * 25 + f"{v1:3d} {v2:3d} {m:2d}" + " " * 10
                + f"{v1:3d} {v2:3d} {m:2d}  {m:2d} {v1:3d} {v2:3d}")
    return [
        "CD  A32 1 " + " " * 4 + "A320 profile   ",
        prof(250, 310, 78),
        prof(250, 310, 78),
        prof(250, 300, 78),
    ]


def synonym_line():
    """The SYNONYM.NEW line mapping ICAO A320 onto ``A320__``
    (CD, 1X, 1S, 1X, 4S, 3X, 18S, 1X, 25S, 1X, 6S, 2X, 1S)."""
    return ("CD - A320   AIRBUS" + " " * 12 + " A-320" + " " * 20
            + " A320__  Y")


def write_bada_dir(path):
    """``SYNONYM.NEW`` + ``A320__.OPF`` + ``A320__.APF`` into ``path``."""
    os.makedirs(path, exist_ok=True)
    for name, lines in (("A320__.OPF", opf_lines()),
                        ("A320__.APF", apf_lines()),
                        ("SYNONYM.NEW", [synonym_line()])):
        with open(os.path.join(path, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    return path


def _el(tag, val, unit=None):
    u = f' unit="{unit}"' if unit is not None else ""
    return f"<{tag}{u}>{val}</{tag}>"


def _aircraft_xml(actype, etype, neng, engines, mtow, mlw, span, sref, swet,
                  crma, crspd, tospd, ldspd, maxspd, maxma, maxalt, cfe,
                  oswald, clmax_to, clmax_cr, clmax_ld):
    return "\n".join([
        "<?xml version='1.0' encoding='utf-8'?>",
        "<aircraft_file>",
        "  " + _el("ac_type", actype),
        "  <engine>",
        "    " + _el("eng_type", etype),
        "    " + _el("num_eng", neng),
        *("    " + _el("eng", e) for e in engines),
        "  </engine>",
        "  <weights>",
        "    " + _el("MTOW", mtow[0], mtow[1]),
        "    " + _el("MLW", mlw[0], mlw[1]),
        "  </weights>",
        "  <dimensions>",
        "    " + _el("span", span[0], span[1]),
        "    " + _el("wing_area", sref[0], sref[1]),
        "    " + _el("wetted_area", swet[0], swet[1]),
        "  </dimensions>",
        "  <speeds>",
        "    " + _el("cr_MA", crma),
        "    " + _el("cr_spd", crspd[0], crspd[1]),
        "    " + _el("to_spd", tospd[0], tospd[1]),
        "    " + _el("ld_spd", ldspd[0], ldspd[1]),
        "  </speeds>",
        "  <limits>",
        "    " + _el("max_spd", maxspd[0], maxspd[1]),
        "    " + _el("max_MA", maxma),
        "    " + _el("max_alt", maxalt[0], maxalt[1]),
        "  </limits>",
        "  <aerodynamics>",
        "    " + _el("Cfe", cfe),
        "    " + _el("oswald", oswald),
        "    " + _el("clmax_to", clmax_to),
        "    " + _el("clmax_cr", clmax_cr),
        "    " + _el("clmax_ld", clmax_ld),
        "  </aerodynamics>",
        "</aircraft_file>", ""])


def _jet_engine_xml(name, thr, bpr_cat, ffs):
    return "\n".join([
        "<?xml version='1.0' encoding='utf-8'?>",
        "<engine_file>",
        "  <engines>",
        "    " + _el("engine", name),
        "    " + _el("eng_type", 1),
        "    " + _el("Thr", thr[0], thr[1]),
        "    " + _el("BPR_cat", bpr_cat),
        "  </engines>",
        "  <ff>",
        *("    " + _el(k, v, "kg/s") for k, v in ffs.items()),
        "  </ff>",
        "</engine_file>", ""])


def _tp_engine_xml(name, power, sfc_to):
    return "\n".join([
        "<?xml version='1.0' encoding='utf-8'?>",
        "<engine_file>",
        "  <engines>",
        "    " + _el("engine", name),
        "    " + _el("eng_type", 2),
        "    " + _el("Power", power[0], power[1]),
        "  </engines>",
        "  <SFC>",
        "    " + _el("SFC_TO", sfc_to[0], sfc_to[1]),
        "  </SFC>",
        "</engine_file>", ""])


def write_bs_dir(path):
    """``aircraft/{A320,B744,AT72}.xml`` + ``engines/*.xml`` into
    ``path``.  The A320 lists an engine the database lacks first (the
    loader takes the first listed engine that exists); the AT72 has
    zero take-off, cruise, limit and Oswald fields (the loader's
    fallbacks); the B744 gives its values in imperial units."""
    acdir = os.path.join(path, "aircraft")
    endir = os.path.join(path, "engines")
    os.makedirs(acdir, exist_ok=True)
    os.makedirs(endir, exist_ok=True)
    aircraft = {
        "A320": _aircraft_xml(
            "A320", 1, 2, ["NOSUCH-1", "CFM56-5B4"], (73500.0, "kg"),
            (64500.0, "kg"), (34.1, "m"), (122.4, "sqm"), (600.0, "sqm"),
            0.78, (250.0, "kts"), (145.0, "kts"), (0.0, "kts"),
            (350.0, "kts"), 0.82, (39800.0, "ft"), 0.0029, 0.78, 2.6,
            1.5, 3.1),
        "B744": _aircraft_xml(
            "B744", 1, 4, ["PW4056"], (875000.0, "lbs"), (630000.0, "lbs"),
            (211.4, "ft"), (5650.0, "sqft"), (2175.0, "sqm"), 0.85,
            (290.0, "kts"), (0.0, "kts"), (150.0, "kts"), (365.0, "kts"),
            0.92, (45100.0, "ft"), 0.0027, 0.82, 2.4, 1.4, 2.9),
        "AT72": _aircraft_xml(
            "AT72", 2, 2, ["PW127F"], (22.8, "t"), (22.35, "t"),
            (27.05, "m"), (61.0, "sqm"), (300.0, "sqm"), 0.0,
            (0.0, "kts"), (0.0, "kts"), (210.0, "km/h"), (0.0, "kts"),
            0.0, (0.0, "ft"), 0.0042, 0.0, 2.2, 1.3, 2.7),
    }
    engines = {
        "CFM56-5B4": _jet_engine_xml(
            "CFM56-5B4", (120.0, "kN"), 2,
            dict(ff_to=1.166, ff_cl=0.961, ff_cr=0.4, ff_ap=0.326,
                 ff_id=0.107)),
        "PW4056": _jet_engine_xml(
            "PW4056", (252000.0, "N"), 1,
            dict(ff_to=2.35, ff_cl=1.95, ff_cr=0.9, ff_ap=0.65,
                 ff_id=0.21)),
        "PW127F": _tp_engine_xml("PW127F", (2051.0, "kW"),
                                 (0.7, "mug/J")),
    }
    for name, text in aircraft.items():
        with open(os.path.join(acdir, f"{name}.xml"), "w") as f:
            f.write(text)
    for name, text in engines.items():
        with open(os.path.join(endir, f"{name}.xml"), "w") as f:
            f.write(text)
    # not an aircraft file: the loader skips what it cannot parse
    with open(os.path.join(acdir, "README.txt"), "w") as f:
        f.write("synthetic BS database\n")
    return path


def write_perf_tree(root):
    """``<root>/BADA`` and ``<root>/BS``; returns ``root``."""
    write_bada_dir(os.path.join(root, "BADA"))
    write_bs_dir(os.path.join(root, "BS"))
    return root
