"""cutadapt-schema JSON reports for the demux rounds.

The reference captures ``--json`` reports from both cutadapt rounds
(02_cutadapt_loop.sh:72,102); downstream tooling that consumes those
files expects cutadapt's documented JSON structure ("Cutadapt report",
schema_version [0, 3]: read_counts / basepair_counts / adapters_read1
with five_prime_end/three_prime_end blocks and per-length
trimmed_lengths histograms keyed by error count). This module emits
that schema from the engine's own per-read decisions (adapter index,
orientation, trim point, error count — exact values from the same DP
that made the trimming decision, not re-estimates).

Copy of ``tpu_orc/demux/report.py``; the code is unchanged.
"""
from __future__ import annotations

import json
import math
import os
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

SCHEMA_VERSION = [0, 3]


def _error_lengths(adapter_len: int, e_rate: float) -> List[int]:
    """cutadapt's error_lengths field: for k = 0, 1, ... the maximum
    match length at which exactly k errors are allowed
    (floor(e_rate * len) == k), ending at the adapter length."""
    out: List[int] = []
    k = 0
    for L in range(1, adapter_len + 1):
        allowed = int(e_rate * L)
        if allowed > k:
            out.append(L - 1)
            k = allowed
    out.append(adapter_len)
    return out


def _trimmed_lengths(hist: Dict[Tuple[int, int], int], n_input: int,
                     adapter_len: int) -> List[Dict]:
    """[{len, expect, counts[by error]}...] sorted by length; expect is
    the random-match expectation n * 0.25^min(len, adapter_len)."""
    by_len: Dict[int, Dict[int, int]] = defaultdict(dict)
    for (ln, err), c in hist.items():
        by_len[ln][err] = by_len[ln].get(err, 0) + c
    rows = []
    for ln in sorted(by_len):
        errs = by_len[ln]
        counts = [errs.get(e, 0) for e in range(max(errs) + 1)]
        rows.append({"len": int(ln),
                     "expect": round(n_input
                                     * 0.25 ** min(ln, adapter_len), 2),
                     "counts": counts})
    return rows


def adapter_entry(name: str, sequence: str, where: str, e_rate: float,
                  matches: int, rc_matches: int,
                  trimmed_hist: Dict[Tuple[int, int], int],
                  n_input: int) -> Dict:
    """One adapters_read1[] element. where: 'front' (-g regular 5') or
    'back' (-a regular 3')."""
    end = {
        "type": ("regular_five_prime" if where == "front"
                 else "regular_three_prime"),
        "sequence": sequence,
        "error_rate": e_rate,
        "indels": True,
        "error_lengths": _error_lengths(len(sequence), e_rate),
        "matches": matches,
        "adjacent_bases": None,
        "dominant_adjacent_base": None,
        "trimmed_lengths": _trimmed_lengths(trimmed_hist, n_input,
                                            len(sequence)),
    }
    return {
        "name": name,
        "total_matches": matches,
        "on_reverse_complement": rc_matches,
        "linked": False,
        "five_prime_end": end if where == "front" else None,
        "three_prime_end": end if where == "back" else None,
    }


def cutadapt_report(*, input_path: str, where: str, e_rate: float,
                    bank, n_input: int, n_output: int, bp_input: int,
                    bp_output: int, n_with_adapter: int, n_rc: int,
                    per_adapter: Dict[str, Dict],
                    command_line: Optional[Sequence[str]] = None) -> Dict:
    """Full cutadapt-schema report dict for one demux round.

    per_adapter: name -> {"matches", "rc", "hist": {(removed_len, err):
    count}} from the engine's decisions."""
    adapters = []
    for name, seq in zip(bank.names, bank.seqs):
        st = per_adapter.get(name, {"matches": 0, "rc": 0, "hist": {}})
        adapters.append(adapter_entry(name, seq, where, e_rate,
                                      st["matches"], st["rc"],
                                      st["hist"], n_input))
    return {
        "tag": "Cutadapt report",
        "schema_version": SCHEMA_VERSION,
        "cutadapt_version": "tpu_orc-equivalent",
        "python_version": sys.version.split()[0],
        "command_line_arguments": list(command_line or []),
        "cores": 1,
        "input": {"path1": input_path, "path2": None, "paired": False},
        "read_counts": {
            "input": n_input,
            "filtered": {
                "too_short": None, "too_long": None, "too_many_n": None,
                "too_many_expected_errors": None,
                "casava_filtered": None, "discard_trimmed": None,
                "discard_untrimmed": None,
            },
            "output": n_output,
            "reverse_complemented": n_rc,
            "read1_with_adapter": n_with_adapter,
            "read2_with_adapter": None,
        },
        "basepair_counts": {
            "input": bp_input, "input_read1": bp_input,
            "input_read2": None,
            "quality_trimmed": None, "quality_trimmed_read1": None,
            "quality_trimmed_read2": None,
            "poly_a_trimmed": None, "poly_a_trimmed_read1": None,
            "poly_a_trimmed_read2": None,
            "output": bp_output, "output_read1": bp_output,
            "output_read2": None,
        },
        "adapters_read1": adapters,
        "adapters_read2": None,
    }


class RoundReportAccum:
    """Streamable counter accumulator behind write_round_reports: call
    ``add(rec, row)`` per read (any chunking), then ``write(...)`` once.
    Holds O(bins x adapters x lengths) counters, never records — the
    streaming demux path's memory contract."""

    def __init__(self):
        self.per1: Dict[str, Dict] = defaultdict(
            lambda: {"matches": 0, "rc": 0, "hist": defaultdict(int)})
        self.n_rc1 = self.n_with1 = 0
        self.bp_in1 = self.bp_out1 = 0
        self.n_records = 0
        self.bin2: Dict[str, Dict] = defaultdict(
            lambda: {"per": defaultdict(
                lambda: {"matches": 0, "rc": 0, "hist": defaultdict(int)}),
                "n_rc": 0, "n_with": 0, "bp_in": 0, "bp_out": 0,
                "rows": 0})

    def add(self, rec, row) -> None:
        sp5_name, trimmed1, sp27_name, final, rc1, err1, rc2, err2 = \
            row[:8]
        self.n_records += 1
        self.bp_in1 += len(rec.seq)
        self.bp_out1 += len(trimmed1.seq)
        if sp5_name is None:
            return
        self.n_with1 += 1
        self.n_rc1 += int(rc1)
        st = self.per1[sp5_name]
        st["matches"] += 1
        st["rc"] += int(rc1)
        st["hist"][(len(rec.seq) - len(trimmed1.seq), int(err1))] += 1
        b = self.bin2[sp5_name]
        b["rows"] += 1
        b["bp_in"] += len(trimmed1.seq)
        b["bp_out"] += len(final.seq)
        if sp27_name is None:
            return
        b["n_with"] += 1
        b["n_rc"] += int(rc2)
        st2 = b["per"][sp27_name]
        st2["matches"] += 1
        st2["rc"] += int(rc2)
        st2["hist"][(len(trimmed1.seq) - len(final.seq), int(err2))] += 1

    def write(self, outdir: str, dataset: str, input_path: str,
              sp5, sp27rc, e_rate: float) -> None:
        rep1 = cutadapt_report(
            input_path=input_path, where="front", e_rate=e_rate,
            bank=sp5, n_input=self.n_records, n_output=self.n_records,
            bp_input=self.bp_in1, bp_output=self.bp_out1,
            n_with_adapter=self.n_with1, n_rc=self.n_rc1,
            per_adapter=self.per1,
            command_line=["--action=trim", "-e", str(e_rate), "--rc",
                          "-g", "file:SP5", "--json"])
        os.makedirs(os.path.join(outdir, "SP5"), exist_ok=True)
        with open(os.path.join(outdir, "SP5",
                               f"cutadapt_SP5_{dataset}.json"),
                  "w") as fh:
            json.dump(rep1, fh, indent=2)
        os.makedirs(os.path.join(outdir, "SP27"), exist_ok=True)
        for sp5_name, b in sorted(self.bin2.items()):
            rep = cutadapt_report(
                input_path=f"{sp5_name}_{dataset}.fastq.gz",
                where="back", e_rate=e_rate, bank=sp27rc,
                n_input=b["rows"], n_output=b["rows"],
                bp_input=b["bp_in"], bp_output=b["bp_out"],
                n_with_adapter=b["n_with"], n_rc=b["n_rc"],
                per_adapter=b["per"],
                command_line=["--action=trim", "-e", str(e_rate),
                              "--rc", "-a", "file:SP27rc", "--json"])
            with open(os.path.join(outdir, "SP27",
                                   f"{sp5_name}_{dataset}.json"),
                      "w") as fh:
                json.dump(rep, fh, indent=2)


def write_round_reports(outdir: str, dataset: str, input_path: str,
                        sp5, sp27rc, e_rate: float, decisions,
                        records) -> None:
    """Write the reference's two report sets from decision rows
    (sp5_name, trimmed1, sp27_name, final, rc1, err1, rc2, err2):

      SP5/cutadapt_SP5_<dataset>.json            (round 1, all reads)
      SP27/<SP5_id>_<dataset>.json               (round 2, per SP5 bin)

    mirroring 02_cutadapt_loop.sh:72,102.
    """
    acc = RoundReportAccum()
    for rec, row in zip(records, decisions):
        acc.add(rec, row)
    acc.write(outdir, dataset, input_path, sp5, sp27rc, e_rate)
