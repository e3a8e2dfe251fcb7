"""Declarative MPI call-spec registry: the interposition layer as DATA.

The paper's core claim is ONE stub library that virtualizes the whole MPI
API against any standards-compliant implementation (§1.2, "develop once,
run everywhere").  Hand-writing each wrapper re-implements translate-on-
entry/exit, record-replay logging, drain participation, and failpoint
arming per method — and lets them silently drift per call.  This module
makes wrapper uniformity STRUCTURAL instead of disciplined:

  * one :class:`CallSpec` entry per MPI call, declaring its handle
    arguments/results (kinds, in/out direction), record-replay policy
    (object-creating / stateless / request-producing / freeing), drain
    participation, collective membership, and the lower-half entry points
    it may touch;
  * :func:`install` GENERATES every ``Mana`` wrapper from its spec, so vid
    translation (``fast``/``slow``/``none``), kind checking, creation-log
    appends, call-transcript recording, and ``mpi.<call>`` failpoint
    arming happen in exactly one place (:func:`_make_wrapper`);
  * collectives are CAPABILITY-GATED: a backend advertising the capability
    gets its native implementation (``Backend.bcast`` etc. — MPICH's
    binomial trees, Open MPI's ring allgather); a backend without it
    (ExaMPI's and fabric-direct's core subsets) gets the spec's derived
    implementation, composed purely from point-to-point sends/receives
    under the same session-valid communicator token.

Every collective RECEIVE routes through the upper half's buffered receive
(``Mana._recv_any``): payloads drained into the checkpoint image at
quiesce time re-deliver transparently after restart, for collectives
exactly as for user point-to-point traffic.

Internal tag schema (the fabric's tag space is open-ended ints):

  user p2p        TAG_USER + tag                (< 2**32)
  internal        (base << 32) | comm_vid       (>= COLL_TAG_MIN)

so concurrent collectives on different communicators never cross-talk,
and drained internal messages are classifiable by tag alone.  Bases are
spaced 100 apart; multi-phase native algorithms offset phases by +10.
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core.descriptors import (Descriptor, Kind, comm_desc,
                                    datatype_desc, group_desc, op_desc,
                                    request_desc)
from repro_torch.core.faults import failpoint
from repro_torch.core.vid import vid_kind

# -- handle encoding (the vid occupies the LOW 32 bits, §1.2 point 2) ------
HANDLE_MAGIC = 0x4D414E41  # 'MANA' in the upper 32 bits of every handle

TAG_USER = 50000
#: internal tag bases (see module docstring); every internal tag is
#: ``(base << 32) | comm_vid``, so anything >= COLL_TAG_MIN is internal
TAG_BASES = {
    "split": 60001,
    "alltoall": 70000,
    "bcast": 70100,
    "reduce": 70200,
    "allreduce": 70300,
    "scatter": 70400,
    "gather": 70500,
    "allgather": 70600,
    "reduce_scatter": 70700,
    "scan": 70800,
    "replica": 70900,   # RAM-tier checkpoint shard push (ckpt_tiers.py)
    "rescale": 71000,   # live membership change: handoff / join (elastic.py)
    "migrate": 71100,   # live serving-session migration (serving/migrate.py)
}
COLL_TAG_MIN = min(TAG_BASES.values()) << 32
#: native multi-phase algorithms offset their second phase by this much
PHASE2 = 10 << 32

TRANSCRIPT_CAP = 256          # bounded call-transcript ring per rank

_POLL_BACKOFF = 5e-5          # waitany/waitsome/wait_all poll start
_POLL_CAP = 5e-3


def make_handle(vid: int) -> int:
    return (HANDLE_MAGIC << 32) | (vid & 0xFFFFFFFF)


def handle_vid(handle: int) -> int:
    return handle & 0xFFFFFFFF


def coll_tag(op: str, comm_vid: int) -> int:
    return (TAG_BASES[op] << 32) | (comm_vid & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# typed errors
# ---------------------------------------------------------------------------

class HandleFreeError(KeyError):
    """Freeing a handle that is unknown, already freed, or of the wrong
    kind.  Before this existed, ``Mana.request_free`` on a double-freed
    handle surfaced as a raw table ``KeyError`` deep inside the vid pages —
    or worse, silently corrupted the legacy shadow tables in slow mode."""

    def __init__(self, call: str, vid: int, why: str):
        self.call = call
        self.vid = vid
        super().__init__(f"{call}: cannot free vid {vid:#x}: {why}")

    def __str__(self) -> str:  # KeyError.__str__ shows repr of args
        return self.args[0]


class HandleKindError(TypeError):
    """A handle of the wrong kind passed where the spec declares another
    (e.g. a communicator handle given to ``request_free``)."""

    def __init__(self, call: str, arg: str, want: Kind, got: Kind):
        self.call, self.arg = call, arg
        super().__init__(f"{call}: argument {arg!r} wants a {want.name} "
                         f"handle, got {got.name}")


class ReduceOpError(ValueError):
    """A reduction collective was given an op with no host-side fold
    (custom ops carry only a name; the host-metadata plane can apply the
    predefined MPI_SUM/MAX/MIN/PROD folds)."""


class NotInCommunicatorError(ValueError):
    """The calling rank is not a member of the communicator it passed to a
    collective."""


# ---------------------------------------------------------------------------
# reduction folds (applied host-side, in communicator-rank order — the
# fold order is part of the call's determinism contract)
# ---------------------------------------------------------------------------

_NP_OPS = {"MPI_SUM": np.add, "MPI_MAX": np.maximum,
           "MPI_MIN": np.minimum, "MPI_PROD": np.multiply}
_PY_OPS = {"MPI_SUM": lambda a, b: a + b, "MPI_MAX": max,
           "MPI_MIN": min, "MPI_PROD": lambda a, b: a * b}


def op_fold(op_desc_: Descriptor) -> Callable:
    """Host-side binary fold for an OP descriptor."""
    name = op_desc_.meta.get("name")
    if name not in _PY_OPS:
        raise ReduceOpError(
            f"op {name!r} has no host-side fold (predefined ops only: "
            f"{sorted(_PY_OPS)})")
    np_op, py_op = _NP_OPS[name], _PY_OPS[name]

    def fold(a, b):
        if isinstance(a, (np.ndarray, list, tuple)) \
                or isinstance(b, (np.ndarray, list, tuple)):
            return np_op(np.asarray(a), np.asarray(b))
        return py_op(a, b)
    return fold


def fold_in_rank_order(m, ranks, tag, own_value, fold):
    """Fold one contribution per member, receiving peers' values through
    the buffered receive and folding in communicator-rank order."""
    acc, first = None, True
    for src in ranks:
        x = own_value if src == m.rank else m._recv_any(src, tag)
        acc, first = (x, False) if first else (fold(acc, x), False)
    return acc


# ---------------------------------------------------------------------------
# spec model
# ---------------------------------------------------------------------------

class Policy(enum.Enum):
    """Record-replay policy of a call (what the checkpoint must capture)."""
    CREATES = "object-creating"        # appended to the record-replay log
    STATELESS = "stateless"            # no upper-half state change
    REQUEST = "request-producing"      # registers a REQUEST vid (drained)
    FREES = "freeing"                  # retires a vid (typed error policy)


_REQUIRED = object()


@dataclass(frozen=True)
class ArgSpec:
    """One wrapper argument.  ``kind`` != None declares a handle argument:
    the generator kind-checks and translates it (virtual -> physical) on
    entry.  ``vector`` marks a list of handles (MPI_Testall-style)."""
    name: str
    kind: Optional[Kind] = None
    vector: bool = False
    optional: bool = False             # None passes through untranslated
    default: Any = _REQUIRED

    @property
    def required(self) -> bool:
        return self.default is _REQUIRED


@dataclass(frozen=True)
class CallSpec:
    """One MPI call, declaratively.

    ``lower(mana, frame)`` is the semantic core: it sees translated
    physical handles (``frame.phys``), descriptors (``frame.desc``) and raw
    arguments (``frame.raw``), and for CREATES/REQUEST policies returns
    ``(descriptor, physical_handle)`` for the generator to register, log,
    and wrap — never touching the vid table or the log itself.

    ``capability``/``fallback`` gate collectives: when the backend does not
    advertise ``capability``, the generator routes to ``fallback`` (the
    derived implementation composed from p2p).  ``uses`` declares every
    lower-half entry point the call may touch — the contract
    ``tools/check_api_coverage.py`` enforces against all backend flavors.
    """
    name: str
    args: tuple
    policy: Policy
    lower: Callable
    doc: str = ""
    result: str = "value"              # "handle" | "value" | "none"
    result_kind: Optional[Kind] = None
    log_op: Optional[str] = None       # creation-log op (CREATES/FREES)
    log_fields: Optional[Callable] = None   # (m, frame, desc) -> payload
    collective: bool = False
    drains: bool = False               # REQUEST vids join the quiesce scan
    capability: Optional[str] = None
    fallback: Optional[Callable] = None
    uses: tuple = ()

    def signature(self) -> str:
        parts = []
        for a in self.args:
            s = a.name
            if a.kind is not None:
                s += f": {a.kind.name}{'[]' if a.vector else ''}"
            if not a.required:
                s += f"={a.default!r}"
            parts.append(s)
        return f"{self.name}({', '.join(parts)})"


class CallFrame:
    """Per-call scratch the generator hands to ``lower``."""
    __slots__ = ("raw", "phys", "desc")

    def __init__(self, raw: dict):
        self.raw = raw
        self.phys: dict = {}
        self.desc: dict = {}


# ---------------------------------------------------------------------------
# wrapper generator — translation, logging, transcripts, failpoints: ONCE
# ---------------------------------------------------------------------------

def _canon(v):
    """Canonical transcript form: handles become ('h', vid) — vids are
    deterministic (ggid hashes + per-kind counters), so transcripts compare
    equal across translation modes AND backend flavors; physical handles
    (which differ per flavor and per session) never enter a transcript."""
    if isinstance(v, bool) or v is None or isinstance(v, (float, str)):
        return v
    if isinstance(v, int):
        return ("h", v & 0xFFFFFFFF) if (v >> 32) == HANDLE_MAGIC else v
    if isinstance(v, (list, tuple)):
        return [_canon(x) for x in v]
    if isinstance(v, dict):
        return {k: _canon(x) for k, x in sorted(v.items())}
    return type(v).__name__


def _free_vid(m, spec: CallSpec, arg: ArgSpec, handle: int) -> int:
    """FREES-policy head: validate kind + liveness with TYPED errors before
    anything is mutated, so a double free can never corrupt the tables."""
    vid = handle_vid(handle)
    kind = vid_kind(vid)
    if arg.kind is not None and kind is not arg.kind:
        raise HandleFreeError(spec.name, vid,
                              f"handle is a {kind.name}, not {arg.kind.name}")
    try:
        m.vids.lookup(vid)
    except KeyError:
        raise HandleFreeError(spec.name, vid,
                              "unknown or already-freed handle") from None
    return vid


def _make_wrapper(spec: CallSpec) -> Callable:
    names = tuple(a.name for a in spec.args)
    name_set = frozenset(names)
    defaults = {a.name: a.default for a in spec.args if not a.required}
    handle_args = tuple(a for a in spec.args if a.kind is not None)
    free_arg = handle_args[0] if spec.policy is Policy.FREES else None

    def wrapper(self, *args, **kwargs):
        if len(args) > len(names):
            raise TypeError(f"{spec.name}() takes at most {len(names)} "
                            f"arguments ({len(args)} given)")
        raw = dict(defaults)
        for n, v in zip(names, args):
            raw[n] = v
        for k, v in kwargs.items():
            if k not in name_set:
                raise TypeError(f"{spec.name}() got an unexpected keyword "
                                f"argument {k!r}")
            raw[k] = v
        for n in names:
            if n not in raw:
                raise TypeError(f"{spec.name}() missing required "
                                f"argument {n!r}")
        failpoint(f"mpi.{spec.name}", rank=self.rank, call=spec.name)
        frame = CallFrame(raw)

        # -- translate-on-entry: every declared handle, exactly here ------
        if free_arg is not None:
            vid = _free_vid(self, spec, free_arg, raw[free_arg.name])
            frame.desc[free_arg.name] = self.vids.lookup(vid)
            frame.phys[free_arg.name] = self._phys(raw[free_arg.name])
        else:
            for a in handle_args:
                h = raw[a.name]
                if h is None and a.optional:
                    continue
                if a.vector:
                    ds, ps = [], []
                    for x in h:
                        d = self._desc(x)
                        _check_kind(spec, a, d)
                        ds.append(d)
                        ps.append(self._phys(x))
                    frame.desc[a.name], frame.phys[a.name] = ds, ps
                else:
                    d = self._desc(h)
                    _check_kind(spec, a, d)
                    frame.desc[a.name] = d
                    frame.phys[a.name] = self._phys(h)

        # -- capability gate: native lower vs derived-from-p2p fallback ---
        impl = spec.lower
        if spec.capability is not None \
                and spec.capability not in self.backend.capabilities():
            impl = spec.fallback
        res = impl(self, frame)

        # -- register / log / transcript: the single exit path ------------
        out = res
        if spec.policy in (Policy.CREATES, Policy.REQUEST):
            if res is not None:          # e.g. comm_split with no local comm
                desc, phys = res
                vid = self._register(desc, phys)
                if spec.policy is Policy.CREATES:
                    payload = spec.log_fields(self, frame, desc) \
                        if spec.log_fields else dict(desc.meta)
                    self.log.append((spec.log_op or spec.name, payload))
                out = make_handle(vid)
            else:
                out = None
        elif spec.policy is Policy.FREES:
            vid = frame.desc[free_arg.name].vid
            if spec.log_op:
                self.log.append((spec.log_op, {"vid": vid}))
            if self.legacy is not None:
                lvid = self._legacy_of.pop(vid, None)
                if lvid is not None:
                    from repro_torch.core.interpose import _KIND_NAME
                    self.legacy.free(_KIND_NAME[vid_kind(vid)], lvid)
            self.vids.free(vid)
            out = None
        self.transcript.append(
            (spec.name, {n: _canon(raw[n]) for n in names}, _canon(out)))
        return out

    wrapper.__name__ = spec.name
    wrapper.__qualname__ = f"Mana.{spec.name}"
    wrapper.__doc__ = (spec.doc or spec.name) + (
        f"\n\n[generated from CallSpec: policy={spec.policy.value}"
        + (f", collective, capability={spec.capability!r}"
           if spec.collective else "") + "]")
    wrapper.__callspec__ = spec
    return wrapper


def _check_kind(spec: CallSpec, arg: ArgSpec, desc: Descriptor) -> None:
    if desc.kind is not arg.kind:
        raise HandleKindError(spec.name, arg.name, arg.kind, desc.kind)


def install(cls) -> None:
    """Generate every wrapper from its spec onto ``cls`` (the Mana class)."""
    for spec in REGISTRY:
        setattr(cls, spec.name, _make_wrapper(spec))
    cls.CALLSPECS = REGISTRY


def spec_for(name: str) -> Optional[CallSpec]:
    return _BY_NAME.get(name)


# ---------------------------------------------------------------------------
# lower bodies: communicators / groups
# ---------------------------------------------------------------------------

def _members(m, frame, arg: str = "comm") -> list:
    """Decode the communicator's members from the LOWER half (§5 category 2
    — never from cached upper-half metadata, which an elastic restart may
    have outgrown)."""
    return m.backend.comm_ranks(frame.phys[arg])


def _my_pos(m, ranks) -> int:
    try:
        return ranks.index(m.rank)
    except ValueError:
        raise NotInCommunicatorError(
            f"rank {m.rank} is not a member of {ranks}") from None


def _l_comm_rank(m, frame):
    return _my_pos(m, _members(m, frame))


def _l_comm_size(m, frame):
    return len(_members(m, frame))


def _l_comm_split(m, frame):
    parent = frame.desc["comm"]
    phys_parent = frame.phys["comm"]
    color, key = frame.raw["color"], frame.raw["key"]
    members = m.backend.comm_ranks(phys_parent)
    tag = coll_tag("split", parent.vid)
    for dst in members:
        m.backend.send(dst, tag, (m.rank, color, key))
    triples = [m._recv_any(src, tag) for src in members]
    mine = sorted([(k, r) for r, c, k in triples if c == color])
    new_members = [r for _, r in mine]
    if not new_members:
        return None
    # capability-gated creation: ExaMPI/fabric-direct subsets have no
    # native split — emulate via comm_create over the computed members
    # (paper §5); the exchange protocol above is shared either way
    if "comm_split" in m.backend.capabilities():
        phys = m.backend.comm_split(phys_parent, color, key, new_members)
    else:
        phys = m.backend.comm_create(new_members)
    return comm_desc(new_members, parent=parent.vid, color=color,
                     key=key), phys


def _l_comm_create(m, frame):
    ranks = list(frame.raw["ranks"])
    return comm_desc(ranks), m.backend.comm_create(ranks)


def _l_comm_group(m, frame):
    phys_g = m.backend.comm_group(frame.phys["comm"])
    ranks = m.backend.group_translate_ranks(phys_g)
    return group_desc(ranks, parent=frame.desc["comm"].vid), phys_g


def _l_group_ranks(m, frame):
    return m.backend.group_translate_ranks(frame.phys["group"])


def _l_comm_free(m, frame):
    m.backend.comm_free(frame.phys["comm"])


# ---------------------------------------------------------------------------
# lower bodies: datatypes / ops
# ---------------------------------------------------------------------------

def _l_type_contiguous(m, frame):
    base_env = m.backend.type_get_envelope(frame.phys["base"])
    env = {"combiner": "contiguous", "count": frame.raw["count"],
           "base": base_env}
    return datatype_desc(env), m.backend.type_create(env)


def _l_type_vector(m, frame):
    base_env = m.backend.type_get_envelope(frame.phys["base"])
    env = {"combiner": "vector", "count": frame.raw["count"],
           "blocklength": frame.raw["blocklength"],
           "stride": frame.raw["stride"], "base": base_env}
    return datatype_desc(env), m.backend.type_create(env)


def _l_type_envelope(m, frame):
    return m.backend.type_get_envelope(frame.phys["dtype"])


def _l_op_create(m, frame):
    name, comm = frame.raw["name"], frame.raw["commutative"]
    return op_desc(name, comm), m.backend.op_create(name, comm)


# ---------------------------------------------------------------------------
# lower bodies: point-to-point + requests
# ---------------------------------------------------------------------------

def _l_isend(m, frame):
    dst, tag = frame.raw["dst"], frame.raw["tag"]
    phys = m.backend.isend(dst, TAG_USER + tag, frame.raw["payload"])
    return request_desc("isend", peer=dst, tag=tag), phys


def _l_grequest_start(m, frame):
    """Generalized request (MPI_Grequest_start): an upper-half-defined
    in-flight operation (e.g. a prefetch batch) that the quiesce protocol
    completes/accounts exactly like pending MPI traffic."""
    op, index = frame.raw["op"], frame.raw["index"]
    phys = m.backend.request_create({"op": op, "index": index})
    d = request_desc(op, tag=index)
    if frame.raw["done"]:
        d.state["done"] = True
    return d, phys


def _l_recv(m, frame):
    return m._recv_any(frame.raw["src"], TAG_USER + frame.raw["tag"])


def _l_iprobe(m, frame):
    """User-surface probe: internal traffic (split protocol, collective
    payloads — drained OR live) is invisible to it; only user-tagged
    messages match, so a wildcard probe can never leak an internal tag
    the matching ``recv`` could not consume."""
    src, tag = frame.raw["src"], frame.raw["tag"]
    for s, t, _ in m.pending_messages:
        if not TAG_USER <= t < COLL_TAG_MIN:
            continue
        if (src in (-1, s)) and (tag == -1 or TAG_USER + tag == t):
            return (s, t - TAG_USER)
    probe = m.backend.iprobe(src, -1 if tag == -1 else TAG_USER + tag)
    if probe is not None and not TAG_USER <= probe[1] < COLL_TAG_MIN:
        return None
    return probe


def _l_test(m, frame):
    done = bool(m.backend.test(frame.phys["request"]))
    frame.desc["request"].state["done"] = done
    return done


def _l_test_all(m, frame):
    flags = m.backend.test_all(frame.phys["requests"])
    for d, done in zip(frame.desc["requests"], flags):
        d.state["done"] = bool(done)
    return [bool(f) for f in flags]


def _l_request_free(m, frame):
    """The vid retire itself happens in the generator's FREES tail; no
    lower-half call — MPI_Request_free only abandons the upper handle."""


def _poll(m, requests, want_all: bool):
    """Shared completion poll: batched test_all with exponential backoff.
    Returns the sorted indices of completed requests."""
    delay = _POLL_BACKOFF
    while True:
        flags = m.test_all(requests)
        done = [i for i, f in enumerate(flags) if f]
        if (all(flags) if want_all else done):
            return done
        time.sleep(delay)
        delay = min(delay * 2, _POLL_CAP)


def _l_wait_all(m, frame):
    if frame.raw["requests"]:
        _poll(m, frame.raw["requests"], want_all=True)


def _l_waitany(m, frame):
    reqs = frame.raw["requests"]
    if not reqs:
        raise ValueError("waitany over an empty request list")
    return _poll(m, reqs, want_all=False)[0]


def _l_waitsome(m, frame):
    reqs = frame.raw["requests"]
    if not reqs:
        return []
    return _poll(m, reqs, want_all=False)


def _l_barrier(m, frame):
    m.backend.barrier(frame.raw["expected"], frame.raw["timeout"])


# ---------------------------------------------------------------------------
# lower bodies: collectives — native dispatch + derived-from-p2p fallbacks
# ---------------------------------------------------------------------------

def _base_impl(name):
    """The GENERIC p2p composition of a collective — the base ``Backend``
    algorithm, invoked UNBOUND so subset flavors (which never override it,
    and do not advertise the capability) get the linear root<->member
    pattern built purely from send/recv.  Flavor overrides (MPICH's tree
    bcast, Open MPI's ring allgather) are deliberately bypassed: this is
    the derived path.  Imported lazily — backends.base imports this module
    for the shared tag schema and typed errors."""
    from repro_torch.core.backends.base import Backend
    return getattr(Backend, name)


def _n_bcast(m, frame):
    return m.backend.bcast(frame.phys["comm"], frame.raw["root"],
                           frame.raw["value"],
                           tag=coll_tag("bcast", frame.desc["comm"].vid),
                           recv=m._recv_any)


def _d_bcast(m, frame):
    return _base_impl("bcast")(
        m.backend, frame.phys["comm"], frame.raw["root"],
        frame.raw["value"], tag=coll_tag("bcast", frame.desc["comm"].vid),
        recv=m._recv_any)


def _n_reduce(m, frame):
    return m.backend.reduce(frame.phys["comm"], frame.raw["root"],
                            frame.raw["value"], op_fold(frame.desc["op"]),
                            tag=coll_tag("reduce", frame.desc["comm"].vid),
                            recv=m._recv_any)


def _d_reduce(m, frame):
    return _base_impl("reduce")(
        m.backend, frame.phys["comm"], frame.raw["root"],
        frame.raw["value"], op_fold(frame.desc["op"]),
        tag=coll_tag("reduce", frame.desc["comm"].vid), recv=m._recv_any)


def _n_allreduce(m, frame):
    return m.backend.allreduce(frame.phys["comm"], frame.raw["value"],
                               op_fold(frame.desc["op"]),
                               tag=coll_tag("allreduce",
                                            frame.desc["comm"].vid),
                               recv=m._recv_any)


def _d_allreduce(m, frame):
    """Derived allreduce: full exchange (every rank sends to every other,
    then folds in rank order) — O(n^2) messages but a single phase, the
    textbook p2p composition."""
    ranks = _members(m, frame)
    _my_pos(m, ranks)
    fold = op_fold(frame.desc["op"])
    tag = coll_tag("allreduce", frame.desc["comm"].vid)
    v = frame.raw["value"]
    for dst in ranks:
        if dst != m.rank:
            m.backend.send(dst, tag, v)
    return fold_in_rank_order(m, ranks, tag, v, fold)


def _n_scatter(m, frame):
    return m.backend.scatter(frame.phys["comm"], frame.raw["root"],
                             frame.raw["values"],
                             tag=coll_tag("scatter", frame.desc["comm"].vid),
                             recv=m._recv_any)


def _d_scatter(m, frame):
    return _base_impl("scatter")(
        m.backend, frame.phys["comm"], frame.raw["root"],
        frame.raw["values"],
        tag=coll_tag("scatter", frame.desc["comm"].vid), recv=m._recv_any)


def _n_gather(m, frame):
    return m.backend.gather(frame.phys["comm"], frame.raw["root"],
                            frame.raw["value"],
                            tag=coll_tag("gather", frame.desc["comm"].vid),
                            recv=m._recv_any)


def _d_gather(m, frame):
    return _base_impl("gather")(
        m.backend, frame.phys["comm"], frame.raw["root"],
        frame.raw["value"],
        tag=coll_tag("gather", frame.desc["comm"].vid), recv=m._recv_any)


def _n_allgather(m, frame):
    return m.backend.allgather(frame.phys["comm"], frame.raw["value"],
                               tag=coll_tag("allgather",
                                            frame.desc["comm"].vid),
                               recv=m._recv_any)


def _d_allgather(m, frame):
    ranks = _members(m, frame)
    _my_pos(m, ranks)
    tag = coll_tag("allgather", frame.desc["comm"].vid)
    v = frame.raw["value"]
    for dst in ranks:
        if dst != m.rank:
            m.backend.send(dst, tag, v)
    return [v if src == m.rank else m._recv_any(src, tag) for src in ranks]


def _n_reduce_scatter(m, frame):
    return m.backend.reduce_scatter(
        frame.phys["comm"], frame.raw["values"],
        op_fold(frame.desc["op"]),
        tag=coll_tag("reduce_scatter", frame.desc["comm"].vid),
        recv=m._recv_any)


def _d_reduce_scatter(m, frame):
    """Derived reduce_scatter: every rank sends slot q straight to member
    q, then folds its own slot's contributions in rank order."""
    ranks = _members(m, frame)
    me = _my_pos(m, ranks)
    values = frame.raw["values"]
    if values is None or len(values) != len(ranks):
        raise ValueError(f"reduce_scatter needs one value per member "
                         f"({len(ranks)}), got "
                         f"{None if values is None else len(values)}")
    fold = op_fold(frame.desc["op"])
    tag = coll_tag("reduce_scatter", frame.desc["comm"].vid)
    for q, dst in enumerate(ranks):
        if dst != m.rank:
            m.backend.send(dst, tag, values[q])
    return fold_in_rank_order(m, ranks, tag, values[me], fold)


def _n_scan(m, frame):
    return m.backend.scan(frame.phys["comm"], frame.raw["value"],
                          op_fold(frame.desc["op"]),
                          tag=coll_tag("scan", frame.desc["comm"].vid),
                          recv=m._recv_any)


def _d_scan(m, frame):
    """Derived inclusive prefix scan: each rank forwards its value to every
    higher-position member and folds positions 0..me in rank order."""
    ranks = _members(m, frame)
    me = _my_pos(m, ranks)
    fold = op_fold(frame.desc["op"])
    tag = coll_tag("scan", frame.desc["comm"].vid)
    v = frame.raw["value"]
    for dst in ranks[me + 1:]:
        m.backend.send(dst, tag, v)
    return fold_in_rank_order(m, ranks[:me + 1], tag, v, fold)


def _n_alltoall(m, frame):
    return m.backend.alltoall(frame.phys["comm"], frame.raw["payloads"],
                              tag=coll_tag("alltoall",
                                           frame.desc["comm"].vid),
                              recv=m._recv_any)


def _d_alltoall(m, frame):
    return _base_impl("alltoall")(
        m.backend, frame.phys["comm"], frame.raw["payloads"],
        tag=coll_tag("alltoall", frame.desc["comm"].vid), recv=m._recv_any)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def _comm(name="comm", **kw):
    return ArgSpec(name, kind=Kind.COMM, **kw)


_P2P_USES = ("comm_ranks", "send", "recv")

REGISTRY: tuple = (
    # -- communicators / groups -------------------------------------------
    CallSpec("comm_rank", (_comm(),), Policy.STATELESS, _l_comm_rank,
             doc="Position of the calling rank in the communicator.",
             uses=("comm_ranks",)),
    CallSpec("comm_size", (_comm(),), Policy.STATELESS, _l_comm_size,
             doc="Number of members, decoded from the lower half.",
             uses=("comm_ranks",)),
    CallSpec("comm_split", (_comm(), ArgSpec("color"), ArgSpec("key")),
             Policy.CREATES, _l_comm_split,
             doc="Collective split of the parent communicator (emulated "
                 "via comm_create on subset backends, paper §5).",
             result="handle", result_kind=Kind.COMM, collective=True,
             log_fields=lambda m, f, d: {
                 "parent": d.meta["parent"], "color": d.meta["color"],
                 "key": d.meta["key"], "ranks": d.meta["ranks"]},
             uses=("comm_ranks", "send", "recv", "comm_split",
                   "comm_create")),
    CallSpec("comm_create", (ArgSpec("ranks"),), Policy.CREATES,
             _l_comm_create, doc="Create a communicator over given ranks.",
             result="handle", result_kind=Kind.COMM,
             log_fields=lambda m, f, d: {"ranks": d.meta["ranks"]},
             uses=("comm_create",)),
    CallSpec("comm_group", (_comm(),), Policy.CREATES, _l_comm_group,
             doc="The communicator's group.",
             result="handle", result_kind=Kind.GROUP,
             log_fields=lambda m, f, d: {"parent": d.meta["parent"],
                                         "ranks": list(d.meta["ranks"])},
             uses=("comm_group", "group_translate_ranks")),
    CallSpec("group_ranks", (ArgSpec("group", kind=Kind.GROUP),),
             Policy.STATELESS, _l_group_ranks,
             doc="Member ranks of a group (decode, §5 category 2).",
             uses=("group_translate_ranks",)),
    CallSpec("comm_free", (_comm(),), Policy.FREES, _l_comm_free,
             doc="Free a communicator (typed error on double free).",
             log_op="free", uses=("comm_free",)),
    # -- datatypes / ops ---------------------------------------------------
    CallSpec("type_contiguous",
             (ArgSpec("count"), ArgSpec("base", kind=Kind.DATATYPE)),
             Policy.CREATES, _l_type_contiguous,
             doc="Contiguous derived datatype.",
             result="handle", result_kind=Kind.DATATYPE, log_op="type_create",
             log_fields=lambda m, f, d: {"envelope": d.meta["envelope"]},
             uses=("type_get_envelope", "type_create")),
    CallSpec("type_vector",
             (ArgSpec("count"), ArgSpec("blocklength"), ArgSpec("stride"),
              ArgSpec("base", kind=Kind.DATATYPE)),
             Policy.CREATES, _l_type_vector,
             doc="Strided vector derived datatype.",
             result="handle", result_kind=Kind.DATATYPE, log_op="type_create",
             log_fields=lambda m, f, d: {"envelope": d.meta["envelope"]},
             uses=("type_get_envelope", "type_create")),
    CallSpec("type_envelope", (ArgSpec("dtype", kind=Kind.DATATYPE),),
             Policy.STATELESS, _l_type_envelope,
             doc="Decode a datatype envelope (rebuildable on ANY backend).",
             uses=("type_get_envelope",)),
    CallSpec("op_create",
             (ArgSpec("name"), ArgSpec("commutative", default=True)),
             Policy.CREATES, _l_op_create, doc="Create a reduction op.",
             result="handle", result_kind=Kind.OP,
             log_fields=lambda m, f, d: {"name": d.meta["name"],
                                         "commutative": d.meta["commutative"]},
             uses=("op_create",)),
    # -- point-to-point / requests ----------------------------------------
    CallSpec("isend", (ArgSpec("dst"), ArgSpec("tag"), ArgSpec("payload")),
             Policy.REQUEST, _l_isend,
             doc="Non-blocking send; returns a REQUEST handle the quiesce "
                 "protocol completes at checkpoint time.",
             result="handle", result_kind=Kind.REQUEST, drains=True,
             uses=("isend",)),
    CallSpec("grequest_start",
             (ArgSpec("op"), ArgSpec("index", default=0),
              ArgSpec("done", default=True)),
             Policy.REQUEST, _l_grequest_start,
             doc="Generalized request (MPI_Grequest_start): upper-half-"
                 "defined in-flight work (prefetch batches) that drains "
                 "like pending MPI traffic.",
             result="handle", result_kind=Kind.REQUEST, drains=True,
             uses=("request_create",)),
    CallSpec("recv", (ArgSpec("src"), ArgSpec("tag")), Policy.STATELESS,
             _l_recv,
             doc="Blocking receive; drained-at-checkpoint messages are "
                 "consumed first, transparently (MANA restart semantics).",
             uses=("recv",)),
    CallSpec("iprobe",
             (ArgSpec("src", default=-1), ArgSpec("tag", default=-1)),
             Policy.STATELESS, _l_iprobe,
             doc="Non-blocking probe over buffered + in-flight messages.",
             uses=("iprobe",)),
    CallSpec("test", (ArgSpec("request", kind=Kind.REQUEST),),
             Policy.STATELESS, _l_test,
             doc="Completion test; mirrors status into the descriptor.",
             uses=("test",)),
    CallSpec("test_all",
             (ArgSpec("requests", kind=Kind.REQUEST, vector=True),),
             Policy.STATELESS, _l_test_all,
             doc="Batched completion test (MPI_Testall): one lower-half "
                 "call for the whole vector.",
             uses=("test_all",)),
    CallSpec("wait_all",
             (ArgSpec("requests", kind=Kind.REQUEST, vector=True),),
             Policy.STATELESS, _l_wait_all,
             doc="Block until every request completes (backoff polling).",
             result="none", uses=("test_all",)),
    CallSpec("waitany",
             (ArgSpec("requests", kind=Kind.REQUEST, vector=True),),
             Policy.STATELESS, _l_waitany,
             doc="Block until SOME request completes; returns its index.",
             uses=("test_all",)),
    CallSpec("waitsome",
             (ArgSpec("requests", kind=Kind.REQUEST, vector=True),),
             Policy.STATELESS, _l_waitsome,
             doc="Block until at least one request completes; returns the "
                 "sorted indices of all completed.",
             uses=("test_all",)),
    CallSpec("request_free", (ArgSpec("request", kind=Kind.REQUEST),),
             Policy.FREES, _l_request_free,
             doc="Retire a request's vid (MPI_Request_free); raises "
                 "HandleFreeError on double-free / unknown handles instead "
                 "of corrupting the vid table.",
             uses=()),
    # -- collectives (capability-gated native vs derived-from-p2p) ---------
    CallSpec("barrier",
             (_comm(optional=True, default=None),
              ArgSpec("expected", default=None),
              ArgSpec("timeout", default=None)),
             Policy.STATELESS, _l_barrier, doc="Rendezvous of the world.",
             result="none", collective=True, uses=("barrier",)),
    CallSpec("bcast",
             (_comm(), ArgSpec("value", default=None),
              ArgSpec("root", default=0)),
             Policy.STATELESS, _n_bcast,
             doc="Broadcast from the member at position `root`; returns "
                 "the value on every rank.",
             collective=True, capability="bcast", fallback=_d_bcast,
             uses=("bcast",) + _P2P_USES),
    CallSpec("reduce",
             (_comm(), ArgSpec("value"), ArgSpec("op", kind=Kind.OP),
              ArgSpec("root", default=0)),
             Policy.STATELESS, _n_reduce,
             doc="Reduce to the member at position `root` (rank-order "
                 "fold); returns the result at root, None elsewhere.",
             collective=True, capability="reduce", fallback=_d_reduce,
             uses=("reduce",) + _P2P_USES),
    CallSpec("allreduce",
             (_comm(), ArgSpec("value"), ArgSpec("op", kind=Kind.OP)),
             Policy.STATELESS, _n_allreduce,
             doc="Reduce + redistribute; every rank returns the identical "
                 "rank-order fold.",
             collective=True, capability="allreduce", fallback=_d_allreduce,
             uses=("allreduce",) + _P2P_USES),
    CallSpec("scatter",
             (_comm(), ArgSpec("values", default=None),
              ArgSpec("root", default=0)),
             Policy.STATELESS, _n_scatter,
             doc="Root distributes values[q] to the member at position q; "
                 "each rank returns its own chunk.",
             collective=True, capability="scatter", fallback=_d_scatter,
             uses=("scatter",) + _P2P_USES),
    CallSpec("gather",
             (_comm(), ArgSpec("value"), ArgSpec("root", default=0)),
             Policy.STATELESS, _n_gather,
             doc="Collect every member's value at position `root` (list in "
                 "rank order); None elsewhere.",
             collective=True, capability="gather", fallback=_d_gather,
             uses=("gather",) + _P2P_USES),
    CallSpec("allgather", (_comm(), ArgSpec("value")),
             Policy.STATELESS, _n_allgather,
             doc="Every rank returns the full rank-ordered value list.",
             collective=True, capability="allgather", fallback=_d_allgather,
             uses=("allgather",) + _P2P_USES),
    CallSpec("reduce_scatter",
             (_comm(), ArgSpec("values"), ArgSpec("op", kind=Kind.OP)),
             Policy.STATELESS, _n_reduce_scatter,
             doc="Elementwise reduce of every member's value vector, "
                 "scattered: position q returns the fold of all values[q].",
             collective=True, capability="reduce_scatter",
             fallback=_d_reduce_scatter,
             uses=("reduce_scatter",) + _P2P_USES),
    CallSpec("scan", (_comm(), ArgSpec("value"), ArgSpec("op", kind=Kind.OP)),
             Policy.STATELESS, _n_scan,
             doc="Inclusive prefix reduction in rank order: position p "
                 "returns the fold of positions 0..p.",
             collective=True, capability="scan", fallback=_d_scan,
             uses=("scan",) + _P2P_USES),
    CallSpec("alltoall", (_comm(), ArgSpec("payloads")),
             Policy.STATELESS, _n_alltoall,
             doc="Personalized exchange: payloads[q] to position q; "
                 "returns the rank-ordered received list.",
             collective=True, capability="alltoall", fallback=_d_alltoall,
             uses=("alltoall",) + _P2P_USES),
)

_BY_NAME = {s.name: s for s in REGISTRY}

#: wrapper names whose REQUEST results the quiesce protocol must complete
DRAINING_CALLS = tuple(s.name for s in REGISTRY if s.drains)
COLLECTIVE_CALLS = tuple(s.name for s in REGISTRY if s.collective)


# ---------------------------------------------------------------------------
# monomorphic fast-path compiler — the "zero interposition tax" leg
# ---------------------------------------------------------------------------

def compile_fastpath(spec: CallSpec, mana, *,
                     transcripts: bool = True) -> Callable:
    """Compile a MONOMORPHIC wrapper for ``spec``, specialized to one Mana
    instance's configuration at generation time.

    The generic :func:`_make_wrapper` pays, on every call, for generality:
    argument-dict assembly with name-set validation, a loop over declared
    handle args with per-arg vector/optional branching, a capability-set
    membership test, and a four-way policy dispatch on the exit path.  The
    compiler burns all of those decisions into straight-line source:

    * the python signature IS the spec signature (defaults native, unknown
      kwargs rejected by the interpreter — no dict build, no name set);
    * vid deref is inlined per argument: ONE table lookup yielding both the
      kind check and the physical handle (the generic path looks up twice,
      in ``_desc`` then ``_phys``);
    * the capability gate is resolved NOW against the live backend, so the
      call body goes straight to the native or derived implementation
      (``self.backend`` is still fetched at call time inside the lower
      body — a halted rank's DeadLowerHalf raises exactly as before);
    * only this spec's policy tail is emitted — no policy dispatch;
    * with ``transcripts=False`` the transcript append is NOT generated at
      all: no branch, no ``_canon`` walk, nothing to mispredict;
    * the failpoint stays, reduced to its true cost: one dict probe.

    Everything observable is unchanged when transcripts are on: same typed
    errors, same creation-log appends, same transcript entries, same
    ``translate_count`` accounting per translation mode (verified by
    tests/test_fastpath.py parity sweep).  Regenerate after swapping a
    backend (``Mana.enable_fastpath`` does this for you).
    """
    from repro_torch.core.faults import _ARMED
    from repro_torch.core.vid import vid_kind as _vid_kind

    names = tuple(a.name for a in spec.args)
    handle_args = tuple(a for a in spec.args if a.kind is not None)
    mode = mana.translation
    legacy = mana.legacy is not None

    impl = spec.lower
    if spec.capability is not None \
            and spec.capability not in mana.backend.capabilities():
        impl = spec.fallback

    ns = {"CallFrame": CallFrame, "_canon": _canon,
          "make_handle": make_handle, "failpoint": failpoint,
          "_ARMED": _ARMED, "_spec": spec, "_impl": impl,
          "_free_vid": _free_vid, "_check_kind": _check_kind,
          "_log_fields": spec.log_fields, "_log_op": spec.log_op or spec.name,
          "_vid_kind": _vid_kind}
    for a in handle_args:
        ns[f"_k_{a.name}"] = a.kind
        ns[f"_a_{a.name}"] = a

    params = ["self"]
    for a in spec.args:
        if a.required:
            params.append(a.name)
        else:
            ns[f"_dflt_{a.name}"] = a.default
            params.append(f"{a.name}=_dflt_{a.name}")

    L = []

    def emit(line="", indent=1):
        L.append("    " * indent + line)

    def emit_deref(arg_name, src, dst, indent):
        """One-lookup vid deref + kind check + lazy bind, per mode."""
        if mode == "slow":
            # legacy tables keep their measured cost model — route through
            # the instrumented slow path, just without the generic plumbing
            emit(f"{dst} = self._desc({src})", indent)
            emit(f"if {dst}.kind is not _k_{arg_name}: "
                 f"_check_kind(_spec, _a_{arg_name}, {dst})", indent)
            emit(f"{dst}_p = self._phys({src})", indent)
            return
        emit(f"{dst} = self.vids.lookup({src} & 0xFFFFFFFF)", indent)
        emit(f"if {dst}.kind is not _k_{arg_name}: "
             f"_check_kind(_spec, _a_{arg_name}, {dst})", indent)
        emit(f"if {dst}.phys is None: self._bind_lazy({dst})", indent)
        if mode == "fast":
            emit("self.translate_count += 1", indent)
        emit(f"{dst}_p = {dst}.phys", indent)

    emit(f"def {spec.name}({', '.join(params)}):", 0)
    emit(f"if _ARMED.get('mpi.{spec.name}'):")
    emit(f"    failpoint('mpi.{spec.name}', rank=self.rank, "
         f"call={spec.name!r})")
    raw_items = ", ".join(f"{n!r}: {n}" for n in names)
    emit(f"frame = CallFrame({{{raw_items}}})")

    if spec.policy is Policy.FREES:
        fa = handle_args[0]
        emit(f"_vid = _free_vid(self, _spec, _a_{fa.name}, {fa.name})")
        emit(f"frame.desc[{fa.name!r}] = self.vids.lookup(_vid)")
        emit(f"frame.phys[{fa.name!r}] = self._phys({fa.name})")
    else:
        for a in handle_args:
            base = 1
            if a.optional:
                emit(f"if {a.name} is not None:")
                base = 2
            if a.vector:
                emit(f"_ds_{a.name} = []; _ps_{a.name} = []", base)
                emit(f"for _h in {a.name}:", base)
                emit_deref(a.name, "_h", f"_d_{a.name}", base + 1)
                emit(f"_ds_{a.name}.append(_d_{a.name}); "
                     f"_ps_{a.name}.append(_d_{a.name}_p)", base + 1)
                emit(f"frame.desc[{a.name!r}] = _ds_{a.name}", base)
                emit(f"frame.phys[{a.name!r}] = _ps_{a.name}", base)
            else:
                emit_deref(a.name, a.name, f"_d_{a.name}", base)
                emit(f"frame.desc[{a.name!r}] = _d_{a.name}", base)
                emit(f"frame.phys[{a.name!r}] = _d_{a.name}_p", base)

    emit("res = _impl(self, frame)")

    if spec.policy in (Policy.CREATES, Policy.REQUEST):
        emit("if res is not None:")
        emit("    desc, phys = res")
        emit("    out = make_handle(self._register(desc, phys))")
        if spec.policy is Policy.CREATES:
            emit("    payload = _log_fields(self, frame, desc) "
                 "if _log_fields is not None else dict(desc.meta)")
            emit("    self.log.append((_log_op, payload))")
        emit("else:")
        emit("    out = None")
    elif spec.policy is Policy.FREES:
        if spec.log_op:
            emit("self.log.append((_log_op, {'vid': _vid}))")
        if legacy:
            emit("_lvid = self._legacy_of.pop(_vid, None)")
            emit("if _lvid is not None:")
            emit("    from repro_torch.core.interpose import _KIND_NAME")
            emit("    self.legacy.free(_KIND_NAME[_vid_kind(_vid)], _lvid)")
        emit("self.vids.free(_vid)")
        emit("out = None")
    else:
        emit("out = res")

    if transcripts:
        tr_items = ", ".join(f"{n!r}: _canon({n})" for n in names)
        emit(f"self.transcript.append(({spec.name!r}, "
             f"{{{tr_items}}}, _canon(out)))")
    emit("return out")

    src = "\n".join(L)
    exec(compile(src, f"<fastpath:{spec.name}>", "exec"), ns)  # noqa: S102
    fn = ns[spec.name]
    fn.__qualname__ = f"Mana.{spec.name}[fastpath]"
    fn.__doc__ = ((spec.doc or spec.name)
                  + f"\n\n[fastpath-compiled: translation={mode}, "
                    f"transcripts={'on' if transcripts else 'off'}]")
    fn.__callspec__ = spec
    fn.__fastpath__ = True
    fn.__source__ = src
    return fn
