"""Run the JAX package's store and the port's store side by side.

:func:`twin` wraps the same object from both packages. Every method call
on a :class:`Twin` runs on both sides with the same arguments (objects
of the reference's classes are rebuilt as the port's, configs and data
directories are split per side), the two answers must be equal — arrays
bit for bit, floats exactly, exceptions of the same class — and the
reference's answer is returned, so a test written against the reference
reads unchanged. Objects that are not plain values (stores, snapshots,
cursors, futures, partitions) come back as Twins themselves.

Directories are split per side: the port's is the reference's with
``.port`` appended. That covers a config's ``data_dir``, ``wal_dir`` and
``event_log_path``,
``pair_class(...).open(path)``, and the directory arguments that the
serving and cluster tiers take as plain values (``_PATH_PARAMS``: a
``Cluster`` root, a ``ship_snapshot`` / ``ShardFollower`` / ``Replica`` /
``add_replica`` destination, the directories in a ``KVServeEngine``'s
``(lo, dir)`` shard list). Paths in answers compare equal when they differ
only by that suffix. A reference ``FaultPlan`` is carried to the port as a
fresh plan with the same rules and random state, made once per plan and
reused, so both sides fire the same faults; an ``IOContext`` takes the
port's plan.

Fields that measure wall time (``*_s``, ``*seconds*``) are not compared,
nor the value words of keys a batched get did not find, nor a latency
histogram's buckets and sums in a ``metrics()`` snapshot: its name, labels
and count are compared. The instruments a store registers when it runs
device views (``DEVICE_VIEW_METRICS``) are left out of the port's snapshot
where the reference, on its host path, has none.
"""
from __future__ import annotations

import dataclasses
import enum
import importlib
import inspect
import os
import weakref

import numpy as np

PORT_CPU = dict(device="cpu")


def _port_class(cls):
    mod = cls.__module__
    if not mod.startswith("repro."):
        return None
    return getattr(importlib.import_module("repro_torch" + mod[len("repro"):]),
                   cls.__name__)


def _port_path(path: str) -> str:
    return str(path).rstrip("/") + ".port"


# parameters that name a directory (``shards``: a list of (lo, dir-or-store))
_PATH_PARAMS = ("root", "dst_dir", "shards")
_PLANS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _port_paths(fn, args, kw):
    """``args`` / ``kw`` of a call to ``fn`` with its directory parameters
    (``_PATH_PARAMS``) given the port's directories."""
    try:
        bound = inspect.signature(fn).bind(*args, **kw)
    except (TypeError, ValueError):
        return args, kw
    for name in _PATH_PARAMS:
        v = bound.arguments.get(name)
        if name == "shards" and isinstance(v, (list, tuple)):
            bound.arguments[name] = [
                (lo, _port_path(d) if isinstance(d, (str, os.PathLike)) else d)
                for lo, d in v]
        elif isinstance(v, (str, os.PathLike)):
            bound.arguments[name] = _port_path(v)
    return list(bound.args), dict(bound.kwargs)


def _port_plan(plan):
    """The port's twin of a reference ``FaultPlan``: the same rules, fired
    counts and random state, made the first time the plan crosses over."""
    if plan not in _PLANS:
        from repro_torch.io import faults as TF

        out = TF.FaultPlan()
        out.rng.setstate(plan.rng.getstate())
        out._rules = [TF._Rule(r.kind, r.match, r.count, r.offset, r.nbytes, r.xor, r.keep)
                      for r in plan._rules]
        out.fired = dict(plan.fired)
        _PLANS[plan] = out
    return _PLANS[plan]


def to_port(x, port_cfg: dict | None = None):
    """A reference-package value as the port takes it."""
    if isinstance(x, Twin):
        return x.port
    if isinstance(x, (list, tuple)):
        return type(x)(to_port(v, port_cfg) for v in x)
    if isinstance(x, dict):
        return {k: to_port(v, port_cfg) for k, v in x.items()}
    if isinstance(x, enum.Enum):
        cls = _port_class(type(x))
        return x if cls is None else cls[x.name]
    if type(x).__module__ == "repro.io.faults":
        if type(x).__name__ == "FaultPlan":
            return _port_plan(x)
        if type(x).__name__ == "IOContext":
            return _port_class(type(x))(
                plan=None if x.plan is None else _port_plan(x.plan), retries=x.retries,
                backoff_s=x.backoff_s, on_retry=x.on_retry, on_giveup=x.on_giveup)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = _port_class(type(x))
        if cls is None:
            return x
        kw = {
            f.name: to_port(getattr(x, f.name), port_cfg)
            for f in dataclasses.fields(x) if f.init
        }
        if cls.__name__ == "RemixDBConfig":
            for key in ("data_dir", "wal_dir", "event_log_path"):
                if kw[key] is not None:
                    kw[key] = _port_path(kw[key])
            if kw["device_path"] == "auto":
                # the reference's "auto" is its legacy path on the CPU;
                # the port's twin drives the device views (plain kernels)
                kw["device_path"] = "on"
        if cls.__name__ in ("RemixDBConfig", "BaselineConfig"):
            kw.update(port_cfg or PORT_CPU)
        out = cls(**kw)
        for f in dataclasses.fields(x):
            if not f.init:
                object.__setattr__(out, f.name, to_port(getattr(x, f.name)))
        return out
    if type(x).__name__ == "Batch" and type(x).__module__ == "repro.db.ops":
        b = _port_class(type(x))(to_port(list(x.ops)))
        for k, v in vars(x).items():
            if k != "ops":
                setattr(b, k, v)
        return b
    return x


def to_ref(x):
    """A value as the reference takes it: Twins give their reference side."""
    if isinstance(x, Twin):
        return x.ref
    if isinstance(x, (list, tuple)):
        return type(x)(to_ref(v) for v in x)
    if isinstance(x, dict):
        return {k: to_ref(v) for k, v in x.items()}
    return x


def _skipped(key) -> bool:
    return isinstance(key, str) and (
        "seconds" in key or key.endswith("_s") or key == "trace"
    )


def plain(x) -> bool:
    if x is None or isinstance(x, (bool, int, float, str, bytes, np.ndarray,
                                   np.generic, enum.Enum, BaseException)):
        return True
    if isinstance(x, (list, tuple, set, frozenset)):
        return all(plain(v) for v in x)
    if isinstance(x, dict):
        return all(plain(v) for k, v in x.items() if not _skipped(k))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return all(plain(getattr(x, f.name)) for f in dataclasses.fields(x)
                   if not _skipped(f.name))
    return False


def _found_vals(x):
    """A (found (Q,) bool, vals (Q, VW)) answer with the values of keys not
    found zeroed: they are unspecified (the reference's own read paths
    leave different words there), so only found rows are compared."""
    if (isinstance(x, tuple) and len(x) == 2
            and all(isinstance(v, np.ndarray) for v in x)
            and x[0].dtype == bool and x[0].ndim == 1 and x[1].ndim == 2
            and len(x[0]) == len(x[1])):
        return x[0], np.where(x[0][:, None], x[1], 0).astype(x[1].dtype)
    return x


def _histogram(x):
    """A metrics snapshot's histogram sample without its latency buckets."""
    if isinstance(x, dict) and x.get("type") == "histogram" and "buckets" in x:
        return {k: x[k] for k in ("name", "type", "labels", "count")}
    return x


# instruments a store registers when it runs device views: the port's twin
# runs them where the reference's host path does not
DEVICE_VIEW_METRICS = frozenset(
    ("device_batches", "device_fallback_total", "device_rows_gathered", "device_view_fetches",
     "hbm_resident_bytes"))


def _metrics(a, b):
    """Two ``metrics()`` snapshots with the port's device-view instruments
    dropped where the reference has none of them."""
    if isinstance(a, dict) and isinstance(b, dict) and set(a) == set(b) == {"metrics"}:
        ref_names = {m["name"] for m in a["metrics"]}
        b = dict(metrics=[m for m in b["metrics"]
                          if m["name"] in ref_names or m["name"] not in DEVICE_VIEW_METRICS])
    return a, b


def _same_str(a: str, b: str) -> bool:
    """Equal strings, or the same path under a twin directory."""
    return a == b or (".port" in b and b.replace(".port", "") == a)


def assert_same(a, b, where="value"):
    """Deep equality of a reference value and the port's."""
    a, b = _found_vals(a), _found_vals(b)
    a, b = _histogram(a), _histogram(b)
    a, b = _metrics(a, b)
    if (dataclasses.is_dataclass(a) and type(a).__name__ == "OpResult"
            and isinstance(a.found, np.ndarray)):
        a = dataclasses.replace(a, vals=_found_vals((a.found, a.vals))[1])
        b = dataclasses.replace(b, vals=_found_vals((b.found, b.vals))[1])
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{where}: dtype {a.dtype} != {b.dtype}"
        assert a.shape == b.shape, f"{where}: shape {a.shape} != {b.shape}"
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, enum.Enum):
        assert type(a).__name__ == type(b).__name__ and a.name == b.name, where
    elif isinstance(a, BaseException):
        assert type(a).__name__ == type(b).__name__, f"{where}: {a!r} != {b!r}"
    elif isinstance(a, (set, frozenset)):
        assert a == b, f"{where}: {sorted(a ^ b, key=str)}"
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{where}: len {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        ka = {k for k in a if not _skipped(k)}
        kb = {k for k in b if not _skipped(k)}
        assert ka == kb, f"{where}: keys {sorted(ka ^ kb, key=str)}"
        for k in ka:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            if not _skipped(f.name):
                assert_same(getattr(a, f.name), getattr(b, f.name),
                            f"{where}.{f.name}")
    elif isinstance(a, np.generic) or isinstance(b, np.generic):
        assert a == b and np.asarray(a).dtype == np.asarray(b).dtype, (
            f"{where}: {a!r} != {b!r}")
    elif isinstance(a, str) and isinstance(b, str):
        assert _same_str(a, b), f"{where}: {a!r} != {b!r}"
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


def twin(a, b, where="value", port_cfg=None):
    if plain(a) and plain(b):
        assert_same(a, b, where)
        return a
    return Twin(a, b, where, port_cfg)


class Twin:
    """The same object in both packages (see the module docstring)."""

    def __init__(self, ref, port, where="twin", port_cfg=None):
        object.__setattr__(self, "ref", ref)
        object.__setattr__(self, "port", port)
        object.__setattr__(self, "where", where)
        object.__setattr__(self, "port_cfg", port_cfg)

    def __getattr__(self, name):
        return twin(getattr(self.ref, name), getattr(self.port, name),
                    f"{self.where}.{name}", self.port_cfg)

    def __setattr__(self, name, value):
        setattr(self.ref, name, value)
        setattr(self.port, name, to_port(value, self.port_cfg))

    def __call__(self, *args, **kw):
        return call_both(self.ref, self.port, args, kw, self.where,
                         self.port_cfg)

    def __len__(self):
        n = len(self.ref)
        assert n == len(self.port), f"{self.where}: len"
        return n

    def __bool__(self):
        return bool(twin(bool(self.ref), bool(self.port), self.where))

    def __getitem__(self, i):
        return twin(self.ref[i], self.port[to_port(i)], f"{self.where}[{i!r}]",
                    self.port_cfg)

    def __iter__(self):
        ir, ip = iter(self.ref), iter(self.port)
        i = 0
        while True:
            try:
                a = next(ir)
            except StopIteration:
                assert next(ip, StopIteration) is StopIteration, (
                    f"{self.where}: the port iterates longer")
                return
            b = next(ip)
            yield twin(a, b, f"{self.where}<{i}>", self.port_cfg)
            i += 1

    def __enter__(self):
        return twin(self.ref.__enter__(), self.port.__enter__(),
                    self.where, self.port_cfg)

    def __exit__(self, *exc):
        self.ref.__exit__(*exc)
        self.port.__exit__(*exc)
        return False


def call_both(fr, fp, args, kw, where="call", port_cfg=None):
    """``fr(*args, **kw)`` and the port's ``fp`` on the same arguments."""
    pargs, pkw = _port_paths(fr, to_port(list(args), port_cfg), to_port(dict(kw), port_cfg))
    args, kw = to_ref(list(args)), to_ref(dict(kw))
    err_r = err_p = None
    try:
        out_r = fr(*args, **kw)
    except Exception as e:  # compared with the port's below, then re-raised
        err_r = e
    try:
        out_p = fp(*pargs, **pkw)
    except Exception as e:
        err_p = e
    if err_r is not None:
        assert err_p is not None, f"{where}: the port did not raise {err_r!r}"
        assert type(err_p).__name__ == type(err_r).__name__, (
            f"{where}: {err_r!r} vs {err_p!r}")
        raise err_r
    if err_p is not None:
        raise AssertionError(f"{where}: only the port raised") from err_p
    return twin(out_r, out_p, f"{where}()", port_cfg)


def pair_class(ref_cls, port_cfg=None):
    """A twin of a reference class or function: what it returns is a Twin
    (``pair_class(RemixDB)(cfg)``, ``pair_class(RemixDB).open(dir, cfg)``,
    ``pair_class(ship_snapshot)(db, dst_dir)``)."""
    port_cls = _port_class(ref_cls)

    class _Pair:
        def __call__(self, *args, **kw):
            return call_both(ref_cls, port_cls, args, kw, ref_cls.__name__,
                             port_cfg)

        def open(self, path, config=None, **kw):
            from repro_torch.db.store import RemixDBConfig

            cfg_p = to_port(config, port_cfg)
            if cfg_p is None:
                cfg_p = RemixDBConfig(**(port_cfg or PORT_CPU))
            return twin(
                ref_cls.open(path, config, **kw),
                port_cls.open(_port_path(path), cfg_p, **kw),
                "open", port_cfg,
            )

    return _Pair()


def twin_dir(path) -> tuple[str, str]:
    """The reference's and the port's directory for one twin data dir."""
    return str(path), _port_path(path)


def clock_pair(monkeypatch, now_fn):
    """Drive both packages' TTL clocks from one logical source."""
    from repro.db import clock as rclock
    from repro_torch.db import clock as tclock

    monkeypatch.setattr(rclock, "_source", now_fn)
    monkeypatch.setattr(tclock, "_source", now_fn)


def same_dir_bytes(ref_dir: str, port_dir: str, subdirs=("tables", "remix"),
                   files=("CURRENT", "wal.log")) -> list[str]:
    """Names of the files compared byte for byte between two data dirs."""
    compared = []
    for sd in subdirs:
        a = sorted(os.listdir(os.path.join(ref_dir, sd)))
        b = sorted(os.listdir(os.path.join(port_dir, sd)))
        assert a == b, (sd, a, b)
        compared += [os.path.join(sd, f) for f in a]
    manifests = sorted(f for f in os.listdir(ref_dir) if f.startswith("MANIFEST-"))
    assert manifests == sorted(
        f for f in os.listdir(port_dir) if f.startswith("MANIFEST-"))
    compared += manifests + [f for f in files
                             if os.path.exists(os.path.join(ref_dir, f))]
    for f in compared:
        with open(os.path.join(ref_dir, f), "rb") as fa, \
                open(os.path.join(port_dir, f), "rb") as fb:
            assert fa.read() == fb.read(), f"{f} differs"
    return compared
