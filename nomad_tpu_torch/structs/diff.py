"""Field-level job diffs for dry-run planning.

Reference: nomad/structs/diff.go — Job.Diff walks the spec producing a
tree of {Added, Deleted, Edited, None} entries per field/object, which
`nomad plan` renders and scheduler/annotate.go attaches to dry-run
plans. One generic dataclass walker replaces the reference's
per-struct hand-rolled methods.

The counterpart of `nomad_tpu.structs.diff`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

DIFF_NONE = "None"
DIFF_ADDED = "Added"
DIFF_DELETED = "Deleted"
DIFF_EDITED = "Edited"

# job fields that never show in a diff (reference: diff.go filters the
# indexes, submit time and other machine-stamped fields)
_JOB_FILTER = {"id", "create_index", "modify_index", "job_modify_index",
               "version", "submit_time", "status", "stable",
               "status_description", "stop"}
_TG_FILTER = {"name"}
_TASK_FILTER = {"name"}


def _scalar(v: Any) -> bool:
    return v is None or isinstance(v, (str, int, float, bool))


def _fmt(v: Any) -> str:
    return "" if v is None else str(v)


def _field_diffs(old, new, filt) -> List[Dict]:
    """Flat scalar fields of a dataclass pair."""
    out: List[Dict] = []
    cls = type(old if old is not None else new)
    for f in dataclasses.fields(cls):
        if f.name in filt:
            continue
        ov = getattr(old, f.name, None) if old is not None else None
        nv = getattr(new, f.name, None) if new is not None else None
        if not (_scalar(ov) and _scalar(nv)):
            continue
        if ov == nv and old is not None and new is not None:
            continue
        if old is None:
            typ = DIFF_ADDED
        elif new is None:
            typ = DIFF_DELETED
        elif ov is None and nv is not None:
            typ = DIFF_ADDED
        elif ov is not None and nv is None:
            typ = DIFF_DELETED
        else:
            typ = DIFF_EDITED
        out.append({"Type": typ, "Name": f.name,
                    "Old": _fmt(ov), "New": _fmt(nv)})
    return sorted(out, key=lambda d: d["Name"])


def _object_diff(name: str, old, new) -> Optional[Dict]:
    """One nested object (constraint/affinity/spread/resources...)."""
    if old is None and new is None:
        return None
    fields = _field_diffs(old, new, set())
    if not fields:
        return None
    typ = (DIFF_ADDED if old is None else
           DIFF_DELETED if new is None else DIFF_EDITED)
    return {"Type": typ, "Name": name, "Fields": fields}


def _object_list_diffs(name: str, olds: list, news: list) -> List[Dict]:
    """Lists of spec objects matched by identity of their full field
    tuple (reference: diff.go's set-based primitiveObjectSetDiff)."""
    def key(o):
        return tuple(_fmt(getattr(o, f.name))
                     for f in dataclasses.fields(o) if _scalar(
                         getattr(o, f.name)))
    old_by = {key(o): o for o in olds or []}
    new_by = {key(o): o for o in news or []}
    out = []
    for k in old_by.keys() - new_by.keys():
        out.append(_object_diff(name, old_by[k], None))
    for k in new_by.keys() - old_by.keys():
        out.append(_object_diff(name, None, new_by[k]))
    return [d for d in out if d]


def task_diff(old, new) -> Dict:
    typ = (DIFF_ADDED if old is None else
           DIFF_DELETED if new is None else DIFF_EDITED)
    fields = _field_diffs(old, new, _TASK_FILTER)
    objects: List[Dict] = []
    o_res = getattr(old, "resources", None) if old else None
    n_res = getattr(new, "resources", None) if new else None
    res = _object_diff("Resources", o_res, n_res)
    if res:
        objects.append(res)
    for attr, label in (("constraints", "Constraint"),
                        ("affinities", "Affinity")):
        objects.extend(_object_list_diffs(
            label, getattr(old, attr, None) if old else [],
            getattr(new, attr, None) if new else []))
    # config is a free dict
    oc = getattr(old, "config", {}) if old else {}
    nc = getattr(new, "config", {}) if new else {}
    cfg = [{"Type": (DIFF_ADDED if k not in oc else
                     DIFF_DELETED if k not in nc else DIFF_EDITED),
            "Name": k, "Old": _fmt(oc.get(k)), "New": _fmt(nc.get(k))}
           for k in sorted(set(oc) | set(nc))
           if oc.get(k) != nc.get(k)]
    if cfg:
        objects.append({"Type": DIFF_EDITED, "Name": "Config",
                        "Fields": cfg})
    if typ == DIFF_EDITED and not fields and not objects:
        typ = DIFF_NONE
    return {"Type": typ,
            "Name": (new or old).name,
            "Fields": fields, "Objects": objects}


def task_group_diff(old, new) -> Dict:
    typ = (DIFF_ADDED if old is None else
           DIFF_DELETED if new is None else DIFF_EDITED)
    fields = _field_diffs(old, new, _TG_FILTER)
    objects: List[Dict] = []
    for attr, label in (("constraints", "Constraint"),
                        ("affinities", "Affinity"),
                        ("spreads", "Spread")):
        objects.extend(_object_list_diffs(
            label, getattr(old, attr, None) if old else [],
            getattr(new, attr, None) if new else []))
    for attr, label in (("ephemeral_disk", "EphemeralDisk"),
                        ("update", "Update"),
                        ("restart_policy", "RestartPolicy"),
                        ("reschedule_policy", "ReschedulePolicy"),
                        ("migrate", "Migrate")):
        d = _object_diff(label, getattr(old, attr, None) if old else None,
                         getattr(new, attr, None) if new else None)
        if d:
            objects.append(d)
    old_tasks = {t.name: t for t in (old.tasks if old else [])}
    new_tasks = {t.name: t for t in (new.tasks if new else [])}
    tasks = []
    for name in sorted(old_tasks.keys() | new_tasks.keys()):
        td = task_diff(old_tasks.get(name), new_tasks.get(name))
        if td["Type"] != DIFF_NONE:
            tasks.append(td)
    if typ == DIFF_EDITED and not fields and not objects and not tasks:
        typ = DIFF_NONE
    return {"Type": typ, "Name": (new or old).name,
            "Fields": fields, "Objects": objects, "Tasks": tasks}


def job_diff(old, new) -> Dict:
    """Top-level diff (reference: diff.go Job.Diff)."""
    if old is None and new is None:
        raise ValueError("nothing to diff")
    typ = (DIFF_ADDED if old is None else
           DIFF_DELETED if new is None else DIFF_EDITED)
    fields = _field_diffs(old, new, _JOB_FILTER)
    # datacenters as a primitive list
    odc = list(getattr(old, "datacenters", []) or []) if old else []
    ndc = list(getattr(new, "datacenters", []) or []) if new else []
    if odc != ndc:
        fields.append({"Type": DIFF_EDITED, "Name": "datacenters",
                       "Old": ",".join(odc), "New": ",".join(ndc)})
    objects: List[Dict] = []
    for attr, label in (("constraints", "Constraint"),
                        ("affinities", "Affinity"),
                        ("spreads", "Spread")):
        objects.extend(_object_list_diffs(
            label, getattr(old, attr, None) if old else [],
            getattr(new, attr, None) if new else []))
    old_tgs = {g.name: g for g in (old.task_groups if old else [])}
    new_tgs = {g.name: g for g in (new.task_groups if new else [])}
    tgs = []
    for name in sorted(old_tgs.keys() | new_tgs.keys()):
        gd = task_group_diff(old_tgs.get(name), new_tgs.get(name))
        if gd["Type"] != DIFF_NONE:
            tgs.append(gd)
    if typ == DIFF_EDITED and not fields and not objects and not tgs:
        typ = DIFF_NONE
    return {"Type": typ, "ID": (new or old).id,
            "Fields": fields, "Objects": objects, "TaskGroups": tgs}
