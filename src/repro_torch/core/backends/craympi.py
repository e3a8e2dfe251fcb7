"""HPE Cray MPI backend: MPICH-family (shared handle encoding and fixed-int
constants) plus vendor-specific struct fields the oblivious layer must never
peek at — the original MANA was accidentally hardwired to these (paper §1.1).
"""
from __future__ import annotations

from repro_torch.core.backends.mpich import MpichBackend


class CrayMpiBackend(MpichBackend):
    name = "craympi"
    family = "mpich"

    def _alloc(self, kind, struct):
        # vendor fields: NIC affinity + ugni/ofi bookkeeping. Present in every
        # struct precisely so tests can assert MANA never depends on them.
        struct = dict(struct)
        struct["_cray_nic"] = self.rank % 4
        struct["_cray_ofi_ep"] = 0xC0FFEE00 | self.rank
        return super()._alloc(kind, struct)

    def comm_split(self, comm, color, key, members_by_color):
        # Cray MPI optimizes splits via its own path; semantics identical
        h = super().comm_split(comm, color, key, members_by_color)
        self._deref("comm", h)["_cray_fast_split"] = True
        return h

    def bcast(self, comm, root, value, *, tag, recv):
        # Cray rides MPICH's binomial tree but keeps NIC-affinity counters
        # on the communicator struct — vendor bookkeeping the oblivious
        # upper half must never depend on (tests assert it round-trips
        # checkpoints untouched)
        st = self._deref("comm", comm)
        st["_cray_coll_count"] = st.get("_cray_coll_count", 0) + 1
        return super().bcast(comm, root, value, tag=tag, recv=recv)
