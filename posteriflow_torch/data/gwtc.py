"""GWTC catalog access: event lookup with a built-in table + optional
network fetch (numpy).

A copy of posteriflow_tpu/data/gwtc.py: the built-in table (published
GWTC-1/2/2.1/3 medians + GWTC-4 exceptional events, ~90 events) is the
primary path; the GWOSC API lookup is gated on the gwosc package and
returns nothing without it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

# Published GWTC parameters: gps, source-frame masses [Msun], distance [Mpc]
_BUILTIN_EVENTS: Dict[str, Dict] = {
    "GW150914": dict(gps=1126259462.4, mass_1=35.6, mass_2=30.6,
                     luminosity_distance=440.0, catalog="GWTC-1"),
    "GW151012": dict(gps=1128678900.4, mass_1=23.2, mass_2=13.6,
                     luminosity_distance=1080.0, catalog="GWTC-1"),
    "GW151226": dict(gps=1135136350.6, mass_1=13.7, mass_2=7.7,
                     luminosity_distance=450.0, catalog="GWTC-1"),
    "GW170104": dict(gps=1167559936.6, mass_1=30.8, mass_2=20.0,
                     luminosity_distance=990.0, catalog="GWTC-1"),
    "GW170608": dict(gps=1180922494.5, mass_1=11.0, mass_2=7.6,
                     luminosity_distance=320.0, catalog="GWTC-1"),
    "GW170729": dict(gps=1185389807.3, mass_1=50.2, mass_2=34.0,
                     luminosity_distance=2840.0, catalog="GWTC-1"),
    "GW170809": dict(gps=1186302519.8, mass_1=35.0, mass_2=23.8,
                     luminosity_distance=1030.0, catalog="GWTC-1"),
    "GW170814": dict(gps=1186741861.5, mass_1=30.6, mass_2=25.2,
                     luminosity_distance=600.0, catalog="GWTC-1"),
    "GW170817": dict(gps=1187008882.4, mass_1=1.46, mass_2=1.27,
                     luminosity_distance=40.0, catalog="GWTC-1",
                     event_type="BNS"),
    "GW170818": dict(gps=1187058327.1, mass_1=35.4, mass_2=26.7,
                     luminosity_distance=1060.0, catalog="GWTC-1"),
    "GW170823": dict(gps=1187529256.5, mass_1=39.5, mass_2=29.0,
                     luminosity_distance=1940.0, catalog="GWTC-1"),
    "GW190412": dict(gps=1239082262.2, mass_1=30.1, mass_2=8.3,
                     luminosity_distance=740.0, catalog="GWTC-2"),
    "GW190521": dict(gps=1242442967.4, mass_1=85.0, mass_2=66.0,
                     luminosity_distance=5300.0, catalog="GWTC-2"),
    "GW190814": dict(gps=1249852257.0, mass_1=23.2, mass_2=2.59,
                     luminosity_distance=241.0, catalog="GWTC-2",
                     event_type="NSBH"),
}


def gps_from_name(name: str) -> Optional[float]:
    """GPS second from a full GWyymmdd_hhmmss event name (GPS epoch
    1980-01-06 UTC; GPS−UTC = 18 s for O1–O4 dates). ±1 s precision —
    catalog-grade lookup without network access."""
    import datetime
    import re
    m = re.fullmatch(r"GW(\d{2})(\d{2})(\d{2})_(\d{2})(\d{2})(\d{2})", name)
    if not m:
        return None
    yy, mo, dd, hh, mi, ss = (int(g) for g in m.groups())
    t = datetime.datetime(2000 + yy, mo, dd, hh, mi, ss)
    epoch = datetime.datetime(1980, 1, 6)
    return (t - epoch).total_seconds() + 18.0


# GWTC-2.1/3 extension: approximate published median source parameters
# (GWTC-2.1: arXiv 2108.01045; GWTC-3: arXiv 2111.03606). GPS derived from
# the full event name (±1 s). Enough for the smoke battery + catalog
# lookups; the reference's live-API depth (gwtc_loader.py:55-700) remains
# behind the gated network fetch.
_EXTENDED = {
    "GW190408_181802": (24.6, 18.4, 1540.0, "GWTC-2", None),
    "GW190425_081805": (2.0, 1.4, 160.0, "GWTC-2", "BNS"),
    "GW190503_185404": (43.0, 28.0, 1450.0, "GWTC-2", None),
    "GW190512_180714": (23.0, 12.6, 1430.0, "GWTC-2", None),
    "GW190517_055101": (37.0, 25.0, 1860.0, "GWTC-2", None),
    "GW190519_153544": (66.0, 40.0, 2600.0, "GWTC-2", None),
    "GW190521_074359": (42.2, 32.8, 1240.0, "GWTC-2", None),
    "GW190602_175927": (69.0, 48.0, 2800.0, "GWTC-2", None),
    "GW190630_185205": (35.0, 24.0, 890.0, "GWTC-2", None),
    "GW190706_222641": (67.0, 38.0, 4400.0, "GWTC-2", None),
    "GW190707_093326": (11.6, 8.4, 770.0, "GWTC-2", None),
    "GW190708_232457": (17.6, 13.0, 880.0, "GWTC-2", None),
    "GW190720_000836": (13.4, 7.8, 790.0, "GWTC-2", None),
    "GW190727_060333": (38.0, 29.0, 3300.0, "GWTC-2", None),
    "GW190728_064510": (12.3, 8.1, 870.0, "GWTC-2", None),
    "GW190828_063405": (32.0, 26.0, 2130.0, "GWTC-2", None),
    "GW190915_235702": (35.0, 24.0, 1620.0, "GWTC-2", None),
    "GW190924_021846": (8.9, 5.0, 550.0, "GWTC-2", None),
    "GW191109_010717": (65.0, 47.0, 1290.0, "GWTC-3", None),
    "GW191129_134029": (10.7, 6.7, 790.0, "GWTC-3", None),
    "GW191204_171526": (11.9, 8.2, 650.0, "GWTC-3", None),
    "GW191216_213338": (12.1, 7.7, 340.0, "GWTC-3", None),
    "GW191222_033537": (45.0, 35.0, 3000.0, "GWTC-3", None),
    "GW200105_162426": (8.9, 1.9, 280.0, "GWTC-3", "NSBH"),
    "GW200112_155838": (35.6, 28.3, 1250.0, "GWTC-3", None),
    "GW200115_042309": (5.7, 1.5, 300.0, "GWTC-3", "NSBH"),
    "GW200129_065458": (34.5, 28.9, 900.0, "GWTC-3", None),
    "GW200202_154313": (10.1, 7.3, 410.0, "GWTC-3", None),
    "GW200224_222234": (40.0, 32.5, 1710.0, "GWTC-3", None),
    "GW200225_060421": (19.3, 14.0, 1150.0, "GWTC-3", None),
    "GW200311_115853": (34.2, 27.7, 1170.0, "GWTC-3", None),
    "GW200316_215756": (13.1, 7.8, 1120.0, "GWTC-3", None),
    # ── GWTC-2.1 deep-catalog completion (arXiv 2108.01045) ──────────────
    # Approximate medians (±~20%); the gated GWOSC API refines these when
    # network exists (reference fallback-table pattern, gwtc_loader.py).
    "GW190403_051519": (85.0, 20.0, 8000.0, "GWTC-2.1", None),
    "GW190413_052954": (34.7, 23.7, 3550.0, "GWTC-2.1", None),
    "GW190413_134308": (47.5, 31.8, 4450.0, "GWTC-2.1", None),
    "GW190421_213856": (41.3, 31.9, 2880.0, "GWTC-2.1", None),
    "GW190426_152155": (5.7, 1.5, 370.0, "GWTC-2.1", "NSBH"),
    "GW190514_065416": (39.0, 28.4, 4500.0, "GWTC-2.1", None),
    "GW190527_092055": (36.5, 22.6, 2500.0, "GWTC-2.1", None),
    "GW190620_030421": (57.1, 35.5, 2800.0, "GWTC-2.1", None),
    "GW190701_203306": (53.9, 40.8, 2060.0, "GWTC-2.1", None),
    "GW190719_215514": (36.5, 20.8, 3900.0, "GWTC-2.1", None),
    "GW190725_174728": (11.5, 6.4, 1000.0, "GWTC-2.1", None),
    "GW190731_140936": (41.5, 28.8, 3300.0, "GWTC-2.1", None),
    "GW190803_022701": (37.3, 27.3, 3270.0, "GWTC-2.1", None),
    "GW190805_211137": (48.2, 32.0, 6000.0, "GWTC-2.1", None),
    "GW190910_112807": (43.9, 35.6, 1460.0, "GWTC-2.1", None),
    "GW190925_232845": (20.8, 15.6, 930.0, "GWTC-2.1", None),
    "GW190929_012149": (80.8, 24.1, 3800.0, "GWTC-2.1", None),
    "GW190930_133541": (12.3, 7.8, 760.0, "GWTC-2.1", None),
    # ── GWTC-3 deep-catalog completion (arXiv 2111.03606) ────────────────
    "GW191103_012549": (11.8, 7.9, 990.0, "GWTC-3", None),
    "GW191105_143521": (10.7, 7.7, 1150.0, "GWTC-3", None),
    "GW191113_071753": (29.0, 5.9, 1370.0, "GWTC-3", None),
    "GW191126_115259": (12.1, 8.3, 1620.0, "GWTC-3", None),
    "GW191127_050227": (53.0, 24.0, 3400.0, "GWTC-3", None),
    "GW191215_223052": (24.9, 18.1, 1930.0, "GWTC-3", None),
    "GW191219_163120": (31.1, 1.17, 550.0, "GWTC-3", "NSBH"),
    "GW191230_180458": (49.4, 37.0, 4300.0, "GWTC-3", None),
    "GW200128_022011": (42.2, 32.6, 3400.0, "GWTC-3", None),
    "GW200208_130117": (37.8, 27.4, 2230.0, "GWTC-3", None),
    "GW200209_085452": (35.6, 27.1, 3400.0, "GWTC-3", None),
    "GW200210_092254": (24.1, 2.83, 940.0, "GWTC-3", "NSBH"),
    "GW200216_220804": (51.0, 30.0, 3800.0, "GWTC-3", None),
    "GW200219_094415": (37.5, 27.9, 3400.0, "GWTC-3", None),
    "GW200220_061928": (87.0, 61.0, 6000.0, "GWTC-3", None),
    "GW200220_124850": (38.9, 27.9, 4000.0, "GWTC-3", None),
    "GW200306_093714": (28.3, 14.8, 2100.0, "GWTC-3", None),
    "GW200308_173609": (36.4, 13.8, 5400.0, "GWTC-3", None),
    "GW200322_091133": (34.0, 14.0, 3600.0, "GWTC-3", None),
    # ── GWTC-4 (O4a) ─────────────────────────────────────────────────────
    # Published exceptional-event medians (GW230529: arXiv 2404.04248 —
    # mass-gap primary + NS; GW231123: the ~massive BBH). Any other
    # GWTC-4 event still resolves through gps_from_name for GPS lookup;
    # full parameter tables ride the gated GWOSC API when network exists
    # (reference: gwtc_loader.py GWTC-4 API path, :55-630).
    "GW230529_181500": (3.6, 1.4, 200.0, "GWTC-4", "NSBH"),
    "GW231123_135430": (137.0, 103.0, 2200.0, "GWTC-4", None),
}

for _name, (_m1, _m2, _dl, _cat, _etype) in _EXTENDED.items():
    _e = dict(gps=gps_from_name(_name), mass_1=_m1, mass_2=_m2,
              luminosity_distance=_dl, catalog=_cat)
    if _etype:
        _e["event_type"] = _etype
    _BUILTIN_EVENTS[_name] = _e
    _BUILTIN_EVENTS.setdefault(_name.split("_")[0], _e)   # short alias


class GWTCLoader:
    def __init__(self, cache_dir: Optional[str] = None):
        self.cache_dir = cache_dir
        self._catalog = dict(_BUILTIN_EVENTS)

    def get_event(self, name: str) -> Dict:
        if name in self._catalog:
            return dict(self._catalog[name], name=name)
        fetched = self._fetch_from_gwosc(name)
        if fetched:
            self._catalog[name] = fetched
            return dict(fetched, name=name)
        # Any full GWyymmdd_hhmmss name (e.g. the ~128 GWTC-4/O4a events
        # beyond the curated table) still resolves to a GPS epoch — enough
        # for strain-window selection; source parameters need the gated
        # GWOSC API (reference: gwtc_loader.py:55-630).
        gps = gps_from_name(name)
        if gps is not None:
            derived = {"gps": gps, "catalog": "name-derived"}
            self._catalog[name] = derived
            return dict(derived, name=name)
        raise KeyError(
            f"unknown event {name!r}; built-in catalog has "
            f"{sorted(self._catalog)} and GWOSC API is unavailable here")

    def get_event_gps_time(self, name: str) -> float:
        """Event name -> GPS (reference _get_event_gps_time:
        gwtc_loader.py:630)."""
        return float(self.get_event(name)["gps"])

    def list_events(self, catalog: Optional[str] = None) -> List[str]:
        return sorted(n for n, e in self._catalog.items()
                      if catalog is None or e.get("catalog") == catalog)

    def _fetch_from_gwosc(self, name: str) -> Optional[Dict]:
        try:                                   # pragma: no cover
            from gwosc.datasets import event_gps
            return {"gps": float(event_gps(name)), "catalog": "gwosc-api"}
        except Exception:
            return None

    # ── synthetic overlap scenarios from the real catalog ────────────────────
    def synthetic_overlap_scenario(self, names: List[str],
                                   dt_range=(-0.5, 0.5),
                                   seed: int = 0) -> List[Dict]:
        """Overlapping-event parameter sets built from catalog events
        (reference: gwtc_loader.py:700). Sky/orientation randomized; merger
        times offset within dt_range."""
        rng = np.random.default_rng(seed)
        out = []
        for i, n in enumerate(names):
            e = self.get_event(n)
            out.append({
                "mass_1": e["mass_1"], "mass_2": e["mass_2"],
                "luminosity_distance": min(e["luminosity_distance"],
                                           2100.0),
                "ra": float(rng.uniform(0, 2 * np.pi)),
                "dec": float(np.arcsin(rng.uniform(-1, 1))),
                "theta_jn": float(np.arccos(rng.uniform(-1, 1))),
                "psi": float(rng.uniform(0, np.pi)),
                "phase": float(rng.uniform(0, 2 * np.pi)),
                "geocent_time": float(rng.uniform(*dt_range)) if i else 0.0,
                "a1": 0.0, "a2": 0.0,
                "source_event": n,
            })
        return out
