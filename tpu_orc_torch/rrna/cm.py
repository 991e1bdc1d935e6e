"""Infernal covariance-model (.cm) ingestion — the pybarrnap variant.

Copy of ``tpu_orc/rrna/cm.py``; only its imports differ (the profiles
are the port's ``rrna/hmm.py`` ``ProfileHMM``) and the citation below,
which names the reference pipeline's README without a checkout path.

The reference names TWO production engines for stage 05 (the reference
pipeline's README.md:50-51): barrnap's nhmmer HMMs and
"pybarrnap v0.5.1 + infernal (Rfam 14.10 CM)". This module ingests the
Rfam-style ``.cm`` files that variant uses.

Scope (documented, not hidden): an Infernal 1.1 CM file stores, per
model, the covariance-model body followed by an embedded HMMER3/f
**p7 filter HMM** ("CM file format", Infernal User Guide) — the linear
profile cmsearch itself runs as its acceleration pipeline's first
stages before any SCFG alignment. We parse the CM headers and score
with that embedded filter HMM through the same batched Viterbi kernel
as the barrnap path (rrna/hmm.py). Full CYK/Inside SCFG scoring —
which differs from the filter only by modeling secondary-structure
base pairs — is out of scope; for locating 18S/28S intervals on
LINEAR reads the filter profile is the operative model, and the
coordinates it yields feed the same extraction contract
(05a_barrnap_rRNA_extract.sh:70-72 layout).

``parse_cm`` maps the RNA alphabet of embedded filters (A C G U) onto
the DNA pipeline (U -> T) and tags each profile with its CM's NAME/ACC
so gene routing can match SSU/LSU/18S/28S naming either way.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Dict, List, Tuple

from .hmm import ProfileHMM, parse_hmmer3


def _split_sections(text: str) -> List[Tuple[Dict[str, str], str]]:
    """[(cm_header_fields, embedded_hmmer3_text), ...] per model."""
    out: List[Tuple[Dict[str, str], str]] = []
    pos = 0
    while True:
        start = text.find("INFERNAL1", pos)
        if start < 0:
            break
        hstart = text.find("HMMER3", start)
        nxt = text.find("INFERNAL1", start + 1)
        if nxt < 0:
            nxt = len(text)
        fields: Dict[str, str] = {}
        cm_part = text[start:hstart if 0 <= hstart < nxt else nxt]
        for line in cm_part.splitlines():
            m = re.match(r"^([A-Z0-9]+)\s+(.*\S)\s*$", line)
            if m and m.group(1) not in ("CM",):
                fields.setdefault(m.group(1), m.group(2))
        if 0 <= hstart < nxt:
            hmm_text = text[hstart:nxt]
            # trim to the filter's own trailing '//'
            end = hmm_text.find("\n//")
            if end >= 0:
                hmm_text = hmm_text[:end + 3] + "\n"
            out.append((fields, hmm_text))
        pos = nxt
    return out


def _rna_to_dna(hmm_text: str) -> str:
    hmm_text = hmm_text.replace("ALPH  RNA", "ALPH  DNA")
    return re.sub(r"^(HMM\s+A\s+C\s+G\s+)U",
                  lambda m: m.group(1) + "T", hmm_text, flags=re.M)


def parse_cm(path: str) -> List[ProfileHMM]:
    """Parse every model in an Infernal 1.1 ``.cm`` file into
    ProfileHMMs (via each model's embedded p7 filter; module
    docstring). Each profile's ``name`` is the CM's NAME field."""
    text = open(path).read()
    sections = _split_sections(text)
    if not sections:
        raise ValueError(f"{path}: no INFERNAL1 models found")
    profiles: List[ProfileHMM] = []
    for fields, hmm_text in sections:
        dna = _rna_to_dna(hmm_text)
        with tempfile.NamedTemporaryFile(
                "w", suffix=".hmm", delete=False) as fh:
            fh.write(dna)
            tmp = fh.name
        try:
            models = parse_hmmer3(tmp)
        finally:
            os.unlink(tmp)
        for m in models:
            m.name = fields.get("NAME", m.name)
            profiles.append(m)
    return profiles


#: gene-name routing for Rfam/barrnap naming conventions
_GENE_PATTERNS = {
    "18S": ("18S", "SSU"),
    "28S": ("28S", "LSU"),
    "5_8S": ("5_8S", "5.8S"),
}


def profiles_by_gene(profiles: List[ProfileHMM]
                     ) -> Dict[str, ProfileHMM]:
    """{gene: profile} for the genes stage 05 extracts, matching CM
    names like SSU_rRNA_eukarya / LSU_rRNA_eukarya (Rfam) or
    18S_rRNA / 28S_rRNA (barrnap)."""
    out: Dict[str, ProfileHMM] = {}
    for p in profiles:
        up = p.name.upper()
        for gene, pats in _GENE_PATTERNS.items():
            if any(pat.upper() in up for pat in pats):
                out.setdefault(gene, p)
                break
    return out
