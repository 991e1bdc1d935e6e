"""Faults planted under a cell's timed path, to show that its check
fails them. Each is a context manager that patches the program in this
process only; ``orc_bench/control.py`` runs them on the card at a
cell's own size, ``orc_bench/tests/test_bench_faults.py`` on the CPU.

A cell can have two of the faults the check must catch (no cell trains
or spans chips): half of a batch left out, and an answer altered where
it is produced. The sort cells' answers are of three kinds (the gene
stage's similarities, the species groups, the consensuses), so each gets
an altered answer of its own.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator


@contextlib.contextmanager
def patched(obj, name: str, new) -> Iterator[None]:
    """``obj.name`` is ``new`` while the block runs."""
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


def demux_half_batch():
    """``FusedDemux.assign`` decides the first half of each batch only."""
    from tpu_orc_torch.demux import fused as F
    orig = F.FusedDemux.assign

    def assign(fd, records, *a, **kw):
        return orig(fd, list(records)[: max(len(records) // 2, 1)], *a, **kw)
    return patched(F.FusedDemux, "assign", assign)


def demux_answer_altered():
    """The fused program's round-2 adapter of every 31st read moved to the
    next adapter, on the device, where the decision is made."""
    from tpu_orc_torch.demux import fused as F
    orig = F._fused_body

    def body(t5, t27, masks, lens, A5, A27, *a, **kw):
        out = orig(t5, t27, masks, lens, A5, A27, *a, **kw).clone()
        k = out[3, ::31]
        out[3, ::31] = (k + 1) % A27
        return out
    return patched(F, "_fused_body", body)


def sort_half_batch():
    """The gene stage's all-vs-all returns the pairs of the first half of
    the block only."""
    from tpu_orc_torch.cluster import scoring as S
    orig = S.DeviceScorer.allvsall_effective_sims

    def allvsall(sc, codes_list, *a, **kw):
        h = orig(sc, codes_list, *a, **kw)
        keep = (h.i < len(codes_list) // 2) & (h.j < len(codes_list) // 2)
        return S.PairHits(h.i[keep], h.j[keep], h.sim[keep], h.reverse[keep])
    return patched(S.DeviceScorer, "allvsall_effective_sims", allvsall)


def sort_similarity_altered():
    """Every 10th similarity the gene stage keeps is 0.001 off."""
    from tpu_orc_torch.cluster import scoring as S
    orig = S.DeviceScorer.allvsall_effective_sims

    def allvsall(sc, codes_list, *a, **kw):
        h = orig(sc, codes_list, *a, **kw)
        sim = h.sim.copy()
        sim[::10] = sim[::10] + 0.001
        return S.PairHits(h.i, h.j, sim, h.reverse)
    return patched(S.DeviceScorer, "allvsall_effective_sims", allvsall)


def sort_consensus_altered():
    """Every consensus the sorter builds loses every 100th base."""
    from tpu_orc_torch.cluster import engine as E
    orig = E.build_consensus

    def build(codes, *a, **kw):
        c = orig(codes, *a, **kw)
        return c[[k for k in range(len(c)) if k % 100 != 99]]
    return patched(E, "build_consensus", build)


def _species_groups(result):
    return [g for species in result.species for g in species]


def sort_groups_altered():
    """The sorter hands 5 reads of its first species group to its
    second."""
    from tpu_orc_torch.cluster import engine as E
    orig = E.AmpliconSorter.sort_records

    def sort_records(sorter, records):
        res = orig(sorter, records)
        groups = _species_groups(res)
        if len(groups) >= 2:
            moved = groups[0].members[:5]
            groups[0].members = groups[0].members[5:]
            groups[1].members = sorted(groups[1].members + moved)
        return res
    return patched(E.AmpliconSorter, "sort_records", sort_records)


def sort_species_dropped():
    """The sorter keeps its first species group only."""
    from tpu_orc_torch.cluster import engine as E
    orig = E.AmpliconSorter.sort_records

    def sort_records(sorter, records):
        res = orig(sorter, records)
        first = True
        for species in res.species:
            species[:] = species[:1] if first else []
            first = first and not species
        return res
    return patched(E.AmpliconSorter, "sort_records", sort_records)


#: the faults of each stage module, by name
FAULTS: Dict[str, Dict] = {
    "demux_stream": {"half_batch": demux_half_batch,
                     "answer_altered": demux_answer_altered},
    "sort_bins": {"half_batch": sort_half_batch,
                  "similarity_altered": sort_similarity_altered,
                  "consensus_altered": sort_consensus_altered,
                  "groups_altered": sort_groups_altered,
                  "species_dropped": sort_species_dropped},
}
