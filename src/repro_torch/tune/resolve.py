""""auto" resolution: turn measured tuning records into launch settings.

Port of ``repro.tune.resolve``.
:class:`~repro_torch.launch.settings.ArchSettings` accepts three tunable
sentinels: ``transport="auto"`` and ``page_bytes="auto"`` (hard: an empty
DB falls back to the defaults with a warning) and ``channels=0`` (soft: 0
already means "unconstrained", so it is upgraded only when a measured
record exists and stays 0 silently otherwise).

Resolution ranks the DB's records for (arch, mesh) by
:meth:`~repro_torch.tune.db.TuningDB.best_config`, each candidate priced
under its own fitted α/bandwidth, honouring any pinned dimension.  This
module imports nothing heavier than :mod:`repro_torch.tune.db`.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import TYPE_CHECKING

from repro_torch.tune.db import DEFAULT_DB_PATH, TuningDB

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.launch.settings import ArchSettings

# the hand-pinned defaults an unresolvable "auto" falls back to
FALLBACK_TRANSPORT = "ring_hier"
FALLBACK_PAGE_BYTES = 2 * 2**20      # the paper's huge page


def has_auto(st: "ArchSettings") -> bool:
    """Any tunable sentinel present (hard or soft)?"""
    return (st.transport == "auto" or st.page_bytes == "auto"
            or st.channels == 0)


def resolve_settings(st: "ArchSettings", arch: str, *,
                     mesh_label: str | None = None,
                     db: TuningDB | None = None,
                     db_path: str | None = None,
                     ref_bytes: float = 256 * 2**20
                     ) -> tuple["ArchSettings", dict]:
    """Resolve ``st``'s ``"auto"`` knobs from the tuning DB.

    Returns ``(settings, info)``: ``info["source"]`` is ``"unchanged"``
    (nothing to resolve), ``"db"`` (resolved from a measured record;
    ``key``/``t_ref_s``/``alpha_s``/``bandwidth`` carry it) or
    ``"fallback"`` (a hard sentinel had no matching record: defaults
    substituted, warning emitted)."""
    if not has_auto(st):
        return st, {"source": "unchanged"}
    if db is None:
        db = TuningDB.load(db_path or DEFAULT_DB_PATH)

    pinned = st.transport if st.transport != "auto" else None
    best = db.best_config(arch=arch, mesh=mesh_label, transport=pinned,
                          ref_bytes=ref_bytes)
    if best is not None:
        resolved = dataclasses.replace(
            st,
            transport=(best["transport"] if st.transport == "auto"
                       else st.transport),
            channels=(best["channels"] if st.channels == 0
                      else st.channels),
            page_bytes=(best["page_bytes"] if st.page_bytes == "auto"
                        else st.page_bytes))
        info = {"source": "db", "key": best["key"],
                "t_ref_s": best["t_ref_s"], "alpha_s": best["alpha_s"],
                "bandwidth": best["bandwidth"]}
        return resolved, info

    hard = [k for k, is_auto in (("transport", st.transport == "auto"),
                                 ("page_bytes", st.page_bytes == "auto"))
            if is_auto]
    if hard:
        warnings.warn(
            f"no tuning-DB record matches arch={arch!r} "
            f"mesh={mesh_label!r} transport={pinned or 'any'!r} "
            f"(db={db.path or '<memory>'}); falling back to defaults for "
            f"{', '.join(hard)} — run `python -m repro_torch.tune.probe "
            f"--out {db.path or DEFAULT_DB_PATH}` to calibrate",
            stacklevel=2)
    resolved = dataclasses.replace(
        st,
        transport=(FALLBACK_TRANSPORT if st.transport == "auto"
                   else st.transport),
        page_bytes=(FALLBACK_PAGE_BYTES if st.page_bytes == "auto"
                    else st.page_bytes))
    # channels == 0 is soft: it already means "unconstrained", keep it
    return resolved, {"source": "fallback", "hard": hard}
