"""Durable streaming ingest: raw record streams -> COO tensors
(≙ splatt_tpu/ingest.py, host code: numpy and the standard library).

A JSONL / CSV / ``.tns`` text stream becomes the ``.bin`` layout
(:func:`splatt_tpu_torch.io.load_memmap`) under four rules:

Exactly-once chunk commits
    The stream is cut into chunks of N records.  Each chunk commits in
    fence order: quarantine sidecar appends first, then the vocab delta
    and the segment file publish atomically
    (:func:`splatt_tpu_torch.utils.durable.publish_bytes`), and the
    chunk's journal record, carrying the raw-byte sha that makes a
    replayed commit idempotent, lands last via
    :func:`splatt_tpu_torch.utils.durable.append_line`.  A SIGKILL
    anywhere resumes from the journal watermark with no record lost or
    duplicated; segment/vocab debris of a crashed commit is overwritten
    bit-identically on re-commit.

Malformed-record quarantine
    Bad arity, non-numeric tokens, out-of-range indices and non-finite
    values are appended to a ``quarantine.jsonl`` sidecar with
    classified ``record_quarantined`` events; past the count/rate budget
    (``SPLATT_INGEST_QUARANTINE_MAX`` / ``SPLATT_INGEST_QUARANTINE_RATE``)
    the run degrades classified (``ingest_degraded``) instead of shipping
    a corrupt tensor.

Vocabulary mapping
    String keys map to mode indices through per-chunk vocab deltas that
    commit with their chunk record (the delta publishes before the
    journal append names its sha), so a crash never leaves the vocab
    ahead of or behind the data.  Numeric vs vocab per mode is decided
    at the first chunk and journaled; cardinalities surface as a
    ``vocab_stats`` event.

Backpressure
    A reader thread stages raw chunks into a bounded queue
    (``SPLATT_INGEST_INFLIGHT``), so parse/commit never falls unboundedly
    behind the read.  The serve ``ingest`` job drives this module against
    a live model store, emitting one ``update`` job per watermark
    interval (serve.py ``_run_ingest``).

The journal keys, the file names under the destination and the bytes of
the segments, vocab deltas and ``tensor.bin`` are the JAX package's, so
either package resumes or audits the other's destination.

Fault sites: ``ingest.read`` (chunk read), ``ingest.vocab`` (vocab delta
publish), ``ingest.commit`` (the journal append fence).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io as _io
import json
import os
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

#: ingest journal record kinds (the `rec` field)
REC_BEGIN = "begin"
REC_CHUNK = "chunk"
REC_FINALIZE = "finalize"
REC_QUARANTINED = "quarantined"

#: quarantine classification vocabulary (the `class` field of sidecar
#: records and ``record_quarantined`` events)
QUARANTINE_CLASSES = ("bad_arity", "bad_token", "bad_index",
                      "nonfinite_value")

#: minimum parsed records before the RATE half of the quarantine
#: budget can trip — a rate over 3 records is noise, not evidence
_RATE_MIN_RECORDS = 200


class IngestError(ValueError):
    """A refusal this module raises deliberately (truncated or corrupt
    journal, misaligned resume, empty source).  Message text includes
    a deterministic marker so :func:`resilience.classify_failure`
    returns a persistable verdict."""


class IngestDegraded(IngestError):
    """The quarantine budget tripped: the stream is too malformed to
    ship.  Committed chunks stay intact and resumable."""


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


# -- pluggable record parsers ------------------------------------------------
#
# A parser turns one raw line into a token list [k0, ..., k_{m-1}, v]
# or None for a non-record line (comment / blank).  Raises ValueError
# for a structurally unparseable line (quarantined as bad_token).

def _parse_tns_line(raw: bytes) -> Optional[List[str]]:
    s = raw.strip()
    if not s or s.startswith(b"#"):
        return None
    return [t.decode("utf-8", errors="replace") for t in s.split()]


def _parse_csv_line(raw: bytes) -> Optional[List[str]]:
    s = raw.strip()
    if not s or s.startswith(b"#"):
        return None
    return [t.decode("utf-8", errors="replace").strip()
            for t in s.split(b",")]


def _parse_jsonl_line(raw: bytes) -> Optional[List[str]]:
    s = raw.strip()
    if not s:
        return None
    rec = json.loads(s.decode("utf-8", errors="replace"))
    if not isinstance(rec, list):
        raise ValueError("jsonl record is not an array")
    return [str(t) for t in rec]


PARSERS: Dict[str, Callable[[bytes], Optional[List[str]]]] = {
    "tns": _parse_tns_line,
    "csv": _parse_csv_line,
    "jsonl": _parse_jsonl_line,
}


def detect_format(source: str) -> str:
    """File-extension format autodetect (``--format auto``)."""
    low = str(source).lower()
    if low.endswith(".csv"):
        return "csv"
    if low.endswith((".jsonl", ".ndjson", ".json")):
        return "jsonl"
    return "tns"


# -- raw chunks and parsed chunks --------------------------------------------


@dataclasses.dataclass
class RawChunk:
    """One chunk of raw source bytes: [lo, hi) with its record lines
    still unparsed.  ``line0`` is the 1-based source line number of
    the first line in ``data`` (quarantine attribution)."""

    n: int
    lo: int
    hi: int
    line0: int
    data: bytes


@dataclasses.dataclass
class ParsedChunk:
    """A chunk after parse + quarantine + vocab mapping, ready to
    publish."""

    n: int
    lo: int
    hi: int
    records: int            # parsed record lines (kept + quarantined)
    quarantined: int
    inds: np.ndarray        # (nmodes, kept) int64
    vals: np.ndarray        # (kept,) float64
    sha: str                # sha of the raw chunk bytes (idempotency)
    line_hi: int            # 1-based line number just past the chunk
    vocab_new: List[List[str]]   # per mode: keys first seen here


def _journal_path(dest: str) -> str:
    return os.path.join(dest, "journal.jsonl")


def _quarantine_path(dest: str) -> str:
    return os.path.join(dest, "quarantine.jsonl")


def _segment_path(dest: str, n: int) -> str:
    return os.path.join(dest, "seg", f"chunk-{n:08d}.npz")


def _vocab_path(dest: str, n: int) -> str:
    return os.path.join(dest, "vocab", f"delta-{n:08d}.json")


def _bin_path(dest: str) -> str:
    return os.path.join(dest, "tensor.bin")


def replay_journal(dest: str) -> Tuple[List[dict], int]:
    """Parse every complete ingest-journal record → (records, torn).
    A torn line — the debris of a writer SIGKILLed mid-append — is
    skipped with a classified ``journal_torn`` event, exactly like the
    serve journal's replay: crash debris is tolerated AND observable.
    A newline-less tail counts as torn even when its bytes decode as
    valid JSON (a writer killed between the write and its newline):
    only a newline-terminated record is committed, so the watermark
    can never rest on an append the fence did not finish."""
    from splatt_tpu_torch import resilience

    path = _journal_path(dest)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return [], 0
    recs: List[dict] = []
    torn = 0
    consumed = 0
    for raw in data.split(b"\n"):
        complete = consumed + len(raw) < len(data)
        consumed += len(raw) + (1 if complete else 0)
        if not raw.strip():
            continue
        try:
            if not complete:
                raise ValueError(
                    "truncated or torn journal tail — append debris "
                    "with no newline")
            rec = json.loads(raw.decode(errors="replace"))
            if not isinstance(rec, dict):
                raise ValueError("journal record is not an object")
        except ValueError as e:
            torn += 1
            resilience.run_report().add(
                "journal_torn", path=path,
                failure_class=resilience.classify_failure(e).value,
                error=resilience.failure_message(e)[:120],
                preview=raw[:60].decode(errors="replace"))
            continue
        recs.append(rec)
    return recs, torn


def audit_journal(dest: str) -> dict:
    """The journal-ALONE exactly-once audit: replay
    the chunk journal and verify, from its records plus the artifacts
    they name, that no chunk is missing below the watermark, no
    ordinal committed twice with different content, every journaled
    segment/vocab file is intact under its recorded sha, and the
    quarantine sidecar accounts for exactly the journaled counts.
    Returns ``{"ok", "violations", "watermark", "chunks", "nnz",
    "records", "quarantined", "finalized"}``, what the ingest soak
    asserts on."""
    recs, torn = replay_journal(dest)
    violations: List[str] = []
    chunks: Dict[int, dict] = {}
    finalized = None
    for r in recs:
        if r.get("rec") == REC_CHUNK:
            n = int(r["n"])
            prev = chunks.get(n)
            if prev is not None and prev.get("sha") != r.get("sha"):
                violations.append(
                    f"chunk {n} journaled twice with different source "
                    f"sha — a duplicated commit")
            chunks[n] = r
        elif r.get("rec") == REC_FINALIZE:
            finalized = r
    watermark = -1
    while (watermark + 1) in chunks:
        watermark += 1
    for n in sorted(chunks):
        if n > watermark:
            violations.append(
                f"chunk {n} journaled above a gap (watermark "
                f"{watermark}) — a lost chunk below it")
    nnz = 0
    records = 0
    quarantined = 0
    for n in range(watermark + 1):
        r = chunks[n]
        nnz += int(r["nnz"])
        records += int(r["records"])
        quarantined += int(r.get("quarantined", 0))
        try:
            with open(_segment_path(dest, n), "rb") as f:
                seg = f.read()
        except OSError:
            violations.append(
                f"chunk {n} journaled but its segment file is missing "
                f"— the watermark claims data that does not exist")
            continue
        if _sha(seg) != r.get("seg_sha"):
            violations.append(
                f"chunk {n} segment content does not match its "
                f"journaled sha — a torn or foreign segment")
        if r.get("vocab_sha"):
            try:
                with open(_vocab_path(dest, n), "rb") as f:
                    vd = f.read()
            except OSError:
                violations.append(
                    f"chunk {n} journaled but its vocab delta is "
                    f"missing — vocab behind the data")
                continue
            if _sha(vd) != r["vocab_sha"]:
                violations.append(
                    f"chunk {n} vocab delta does not match its "
                    f"journaled sha")
    # the quarantine sidecar accounts for every journaled quarantine:
    # unique (chunk, line) pairs per chunk must cover each chunk's
    # journaled count.  Duplicates are tolerated debris — a crash
    # between a sidecar append and the journal fence re-parses the
    # chunk and re-appends the same record; the journal stays the
    # authority
    qseen: Dict[int, set] = {}
    try:
        with open(_quarantine_path(dest), "rb") as f:
            for raw in f.read().split(b"\n"):
                if not raw.strip():
                    continue
                try:
                    q = json.loads(raw.decode(errors="replace"))
                except ValueError:
                    continue  # torn sidecar tail: its chunk never committed
                qseen.setdefault(int(q.get("chunk", -1)), set()).add(
                    (q.get("line"), q.get("offset")))
    except OSError:
        pass
    for n in range(watermark + 1):
        want = int(chunks[n].get("quarantined", 0))
        got = len(qseen.get(n, ()))
        if got < want:
            violations.append(
                f"chunk {n} journals {want} quarantined record(s) but "
                f"the sidecar accounts only {got}")
    if finalized is not None and int(finalized.get("nnz", -1)) != nnz:
        violations.append(
            f"finalize record claims nnz={finalized.get('nnz')} but "
            f"the committed chunks sum to {nnz}")
    return {"ok": not violations, "violations": violations,
            "watermark": watermark, "chunks": watermark + 1,
            "nnz": nnz, "records": records, "quarantined": quarantined,
            "torn": torn, "finalized": finalized is not None}


# -- the ingest state machine ------------------------------------------------


class IngestState:
    """One ingest run's committed state: watermark, vocab, counters.

    Construction replays the journal (resume-aware); per-chunk work
    flows through :meth:`commit_chunk` in the fence order the
    crash-point checker models (quarantine → vocab publish → segment
    publish → journal append LAST)."""

    def __init__(self, source: str, dest: str, fmt: str = "auto",
                 chunk_records: Optional[int] = None,
                 dims: Optional[Tuple[int, ...]] = None,
                 quarantine_max: Optional[int] = None,
                 quarantine_rate: Optional[float] = None):
        from splatt_tpu_torch import resilience, trace
        from splatt_tpu_torch.utils.env import read_env_float, read_env_int

        self.source = str(source)
        self.dest = str(dest)
        self.fmt = detect_format(source) if fmt in (None, "auto") \
            else str(fmt)
        if self.fmt not in PARSERS:
            raise IngestError(
                f"unknown ingest format {self.fmt!r} — not implemented "
                f"(want one of {sorted(PARSERS)})")
        self.chunk_records = int(chunk_records
                                 or read_env_int("SPLATT_INGEST_CHUNK"))
        if self.chunk_records <= 0:
            raise IngestError("chunk_records must be positive")
        self.dims = tuple(int(d) for d in dims) if dims else None
        self.quarantine_max = int(
            quarantine_max if quarantine_max is not None
            else read_env_int("SPLATT_INGEST_QUARANTINE_MAX"))
        self.quarantine_rate = float(
            quarantine_rate if quarantine_rate is not None
            else read_env_float("SPLATT_INGEST_QUARANTINE_RATE"))
        os.makedirs(os.path.join(self.dest, "seg"), exist_ok=True)
        os.makedirs(os.path.join(self.dest, "vocab"), exist_ok=True)
        # mode policy (decided at the first chunk, journaled with it)
        self.nmodes: Optional[int] = None
        self.vocab_modes: Optional[List[bool]] = None
        self.vocab: List[Dict[str, int]] = []
        self.max_index: List[int] = []
        # committed counters (journal-derived on resume)
        self.watermark = -1
        self.resume_offset = 0
        self.resume_line = 1
        self.nnz_total = 0
        self.records_total = 0
        self.quarantined_total = 0
        self.finalized: Optional[dict] = None
        self.resumed = False
        self._replay(resilience, trace)

    # -- resume --------------------------------------------------------------

    def _replay(self, resilience, trace) -> None:
        recs, _torn = replay_journal(self.dest)
        chunks: Dict[int, dict] = {}
        begin = None
        for r in recs:
            if r.get("rec") == REC_BEGIN:
                begin = r
            elif r.get("rec") == REC_CHUNK:
                n = int(r["n"])
                prev = chunks.get(n)
                if prev is not None and prev.get("sha") != r.get("sha"):
                    raise IngestError(
                        f"{_journal_path(self.dest)}: chunk {n} "
                        f"journaled twice with different source sha — "
                        f"truncated or torn journal state")
                chunks[n] = r
            elif r.get("rec") == REC_FINALIZE:
                self.finalized = r
        if begin is None:
            from splatt_tpu_torch.utils.durable import append_line

            append_line(_journal_path(self.dest), json.dumps(
                {"rec": REC_BEGIN, "source": os.path.abspath(self.source),
                 "format": self.fmt,
                 "chunk_records": self.chunk_records,
                 "ts": time.time()}, sort_keys=True).encode())
            return
        if int(begin.get("chunk_records", 0)) != self.chunk_records \
                or str(begin.get("format")) != self.fmt:
            raise IngestError(
                f"{self.dest}: resume with chunk_records="
                f"{self.chunk_records}/format={self.fmt} against a "
                f"journal begun with chunk_records="
                f"{begin.get('chunk_records')}/format="
                f"{begin.get('format')} — chunk offsets would "
                f"misalign; this mismatch is deterministic, use a "
                f"fresh dest")
        while (self.watermark + 1) in chunks:
            self.watermark += 1
        skipped = 0
        for n in range(self.watermark + 1):
            r = chunks[n]
            self._verify_committed(r)
            if n == 0 and r.get("policy"):
                pol = r["policy"]
                self.nmodes = int(pol["nmodes"])
                self.vocab_modes = [bool(b) for b in pol["vocab_modes"]]
                self.vocab = [dict() for _ in range(self.nmodes)]
                self.max_index = [-1] * self.nmodes
            self._replay_vocab(n, r)
            self.nnz_total += int(r["nnz"])
            self.records_total += int(r["records"])
            self.quarantined_total += int(r.get("quarantined", 0))
            self.resume_offset = int(r["hi"])
            self.resume_line = int(r.get("line_hi", 1))
            skipped += 1
        if skipped:
            self.resumed = True
            trace.metric_inc("splatt_ingest_chunks_total",
                             float(skipped), outcome="skipped")
            trace.metric_set("splatt_ingest_watermark",
                             float(self.watermark))
            resilience.run_report().add(
                "ingest_resumed", dest=self.dest, chunks=skipped,
                watermark=self.watermark, offset=self.resume_offset,
                nnz=self.nnz_total,
                quarantined=self.quarantined_total)

    def _verify_committed(self, r: dict) -> None:
        """A journaled chunk must still be intact on disk — a resume
        over torn artifacts must refuse, never double-count."""
        n = int(r["n"])
        try:
            with open(_segment_path(self.dest, n), "rb") as f:
                seg = f.read()
        except OSError as e:
            raise IngestError(
                f"{self.dest}: chunk {n} is journaled but its segment "
                f"is unreadable ({e}) — truncated or torn ingest "
                f"state; the journal is the watermark, so this is "
                f"unrecoverable debris") from e
        if _sha(seg) != r.get("seg_sha"):
            raise IngestError(
                f"{self.dest}: chunk {n} segment does not match its "
                f"journaled sha — truncated or torn segment")

    def _replay_vocab(self, n: int, r: dict) -> None:
        if not r.get("vocab_sha"):
            # numeric-only chunk: track per-mode max from the segment
            inds, _ = load_segment(self.dest, n)
            if self.nmodes is None:
                return
            for m in range(self.nmodes):
                if inds.shape[1]:
                    self.max_index[m] = max(self.max_index[m],
                                            int(inds[m].max()))
            return
        with open(_vocab_path(self.dest, n), "rb") as f:
            data = f.read()
        if _sha(data) != r["vocab_sha"]:
            raise IngestError(
                f"{self.dest}: chunk {n} vocab delta does not match "
                f"its journaled sha — truncated or torn vocab state")
        delta = json.loads(data.decode())
        for ms, keys in delta.get("modes", {}).items():
            m = int(ms)
            for k in keys:
                self.vocab[m][k] = len(self.vocab[m])
        inds, _ = load_segment(self.dest, n)
        for m in range(self.nmodes or 0):
            if inds.shape[1]:
                self.max_index[m] = max(self.max_index[m],
                                        int(inds[m].max()))

    # -- chunked reading (the ingest.read fault site) ------------------------

    def read_chunks(self, stop: Optional[Callable[[], bool]] = None):
        """Yield :class:`RawChunk` objects from the resume offset on.
        Chunk boundaries fall on record lines (comments/blanks ride
        along), so ``lo``/``hi`` are exact byte offsets into the
        source — what the journal records and a resume seeks to."""
        from splatt_tpu_torch.utils import faults

        n = self.watermark + 1
        line = self.resume_line
        with open(self.source, "rb") as f:
            f.seek(self.resume_offset)
            while not (stop is not None and stop()):
                faults.maybe_fail("ingest.read")
                lo = f.tell()
                line0 = line
                buf: List[bytes] = []
                records = 0
                while records < self.chunk_records:
                    raw = f.readline()
                    if not raw:
                        break
                    buf.append(raw)
                    line += 1
                    s = raw.strip()
                    if s and not (self.fmt != "jsonl"
                                  and s.startswith(b"#")):
                        records += 1
                if not records:
                    return
                yield RawChunk(n=n, lo=lo, hi=f.tell(), line0=line0,
                               data=b"".join(buf))
                n += 1

    # -- parse + quarantine --------------------------------------------------

    def _decide_policy(self, rows: List[List[str]]) -> None:
        """First-chunk mode policy: arity = the first record's, and a
        mode is NUMERIC iff every first-chunk token parses as a
        non-negative integer (otherwise it is vocab-mapped for the
        whole run).  Journaled with chunk 0 so a resume replays the
        same decision."""
        if not rows:
            raise IngestError(
                f"{self.source}: empty tensor stream — no record "
                f"survived the first chunk's parse")
        self.nmodes = len(rows[0]) - 1
        if self.nmodes < 1:
            raise IngestError(
                f"{self.source}: records need >= 2 columns "
                f"(indices... value); got {len(rows[0])}")
        if self.dims is not None and len(self.dims) != self.nmodes:
            raise IngestError(
                f"{self.source}: declared dims carry {len(self.dims)} "
                f"mode(s) but the records carry {self.nmodes} — this "
                f"mismatch is deterministic, fix the declared dims")
        self.vocab_modes = []
        for m in range(self.nmodes):
            numeric = True
            for r in rows:
                if len(r) != self.nmodes + 1:
                    continue
                t = r[m]
                if not (t.isdigit() or (t.startswith("-")
                                        and t[1:].isdigit())):
                    numeric = False
                    break
            self.vocab_modes.append(not numeric)
        self.vocab = [dict() for _ in range(self.nmodes)]
        self.max_index = [-1] * self.nmodes

    def _quarantine(self, rc: RawChunk, lineno: int, offset: int,
                    cls: str, raw: str, detail: str) -> None:
        from splatt_tpu_torch import resilience, trace
        from splatt_tpu_torch.utils.durable import append_line

        append_line(_quarantine_path(self.dest), json.dumps(
            {"rec": REC_QUARANTINED, "chunk": rc.n, "line": lineno,
             "offset": offset, "class": cls, "detail": detail,
             "raw": raw[:200]}, sort_keys=True).encode())
        resilience.run_report().add(
            "record_quarantined", chunk=rc.n, line=lineno,
            offset=offset, quarantine_class=cls, detail=detail[:120])
        trace.metric_inc("splatt_ingest_records_total",
                         outcome="quarantined")
        self._q_pending += 1
        if self.quarantine_max > 0 and \
                self.quarantined_total + self._q_pending \
                > self.quarantine_max:
            raise IngestDegraded(
                f"{self.source}: quarantine budget exhausted "
                f"({self.quarantined_total + self._q_pending} bad "
                f"records > SPLATT_INGEST_QUARANTINE_MAX="
                f"{self.quarantine_max}) — refusing to ship a tensor "
                f"this malformed; not implemented as a best-effort "
                f"parse by design")

    def parse_chunk(self, rc: RawChunk) -> ParsedChunk:
        """Parse one raw chunk: tokenize, quarantine malformed
        records (durable sidecar append BEFORE the chunk can commit),
        map vocab modes, and return the publishable arrays."""
        parse_line = PARSERS[self.fmt]
        self._q_pending = 0
        records = 0
        rows: List[Tuple[int, int, List[str]]] = []  # (line, off, toks)
        off = rc.lo
        lineno = rc.line0
        for raw in rc.data.split(b"\n"):
            this_line, this_off = lineno, off
            lineno += 1
            off += len(raw) + 1
            if not raw.strip():
                continue
            try:
                toks = parse_line(raw)
            except ValueError as e:
                records += 1
                self._quarantine(rc, this_line, this_off, "bad_token",
                                 raw.decode(errors="replace"), str(e))
                continue
            if toks is None:
                continue
            records += 1
            rows.append((this_line, this_off, toks))
        if self.nmodes is None:
            self._decide_policy([t for _, _, t in rows])
        kept_inds: List[List[int]] = []
        kept_vals: List[float] = []
        vocab_new: List[List[str]] = [[] for _ in range(self.nmodes)]
        for this_line, this_off, toks in rows:
            raw = " ".join(toks)
            if len(toks) != self.nmodes + 1:
                self._quarantine(
                    rc, this_line, this_off, "bad_arity", raw,
                    f"expected {self.nmodes + 1} columns, got "
                    f"{len(toks)}")
                continue
            try:
                val = float(toks[-1])
            except ValueError:
                self._quarantine(rc, this_line, this_off, "bad_token",
                                 raw, f"non-numeric value {toks[-1]!r}")
                continue
            if not np.isfinite(val):
                self._quarantine(rc, this_line, this_off,
                                 "nonfinite_value", raw,
                                 f"non-finite value {toks[-1]!r}")
                continue
            idx: List[int] = []
            bad = None
            # vocab inserts stage here and commit only once the whole
            # record validates — a quarantined record must not grow
            # the vocab (vocab-watermark atomicity at record grain)
            staged: List[Tuple[int, str]] = []
            for m in range(self.nmodes):
                t = toks[m]
                if self.vocab_modes[m]:
                    known = self.vocab[m].get(t)
                    if known is None:
                        known = len(self.vocab[m]) + sum(
                            1 for sm, _ in staged if sm == m)
                        # declared dims bound the vocabulary too: a
                        # delta built past the base model's mode size
                        # would index factor rows that do not exist
                        if self.dims is not None \
                                and known >= self.dims[m]:
                            bad = ("bad_index",
                                   f"new key {t!r} would grow mode "
                                   f"{m} vocabulary past declared dim "
                                   f"{self.dims[m]}")
                            break
                        staged.append((m, t))
                    idx.append(known)
                    continue
                try:
                    i = int(t)
                except ValueError:
                    bad = ("bad_token",
                           f"non-integer index {t!r} in numeric "
                           f"mode {m}")
                    break
                if i < 0 or (self.dims is not None
                             and i >= self.dims[m]):
                    bad = ("bad_index",
                           f"index {i} out of range for mode {m}"
                           + (f" (dim {self.dims[m]})"
                              if self.dims else ""))
                    break
                idx.append(i)
            if bad is not None:
                self._quarantine(rc, this_line, this_off, bad[0], raw,
                                 bad[1])
                continue
            for m, t in staged:
                self.vocab[m][t] = len(self.vocab[m])
                vocab_new[m].append(t)
            kept_inds.append(idx)
            kept_vals.append(val)
        seen = self.records_total + records
        qtot = self.quarantined_total + self._q_pending
        if self.quarantine_rate > 0 and seen >= _RATE_MIN_RECORDS \
                and qtot / max(seen, 1) > self.quarantine_rate:
            raise IngestDegraded(
                f"{self.source}: quarantine rate {qtot}/{seen} "
                f"exceeds SPLATT_INGEST_QUARANTINE_RATE="
                f"{self.quarantine_rate:g} — refusing to ship a "
                f"tensor this malformed; not implemented as a "
                f"best-effort parse by design")
        inds = (np.asarray(kept_inds, dtype=np.int64).T
                if kept_inds else
                np.zeros((self.nmodes, 0), dtype=np.int64))
        vals = np.asarray(kept_vals, dtype=np.float64)
        line_hi = rc.line0 + rc.data.count(b"\n") \
            + (0 if rc.data.endswith(b"\n") or not rc.data else 1)
        return ParsedChunk(
            n=rc.n, lo=rc.lo, hi=rc.hi, records=records,
            quarantined=self._q_pending, inds=np.ascontiguousarray(inds),
            vals=vals, sha=_sha(rc.data), line_hi=line_hi,
            vocab_new=vocab_new)

    # -- the durable commit (fence order) ---------------------------------------

    def vocab_bytes(self, pc: ParsedChunk) -> Optional[bytes]:
        """This chunk's vocab-delta payload (deterministic bytes), or
        None when no mode is vocab-mapped."""
        if not any(self.vocab_modes or []):
            return None
        return json.dumps(
            {"chunk": pc.n,
             "modes": {str(m): keys
                       for m, keys in enumerate(pc.vocab_new)}},
            sort_keys=True).encode()

    def segment_bytes(self, pc: ParsedChunk) -> bytes:
        """This chunk's COO segment payload.  Deterministic bytes
        (np.savez stamps the epoch, not wall time): a re-commit after
        a crash overwrites orphan debris bit-identically."""
        buf = _io.BytesIO()
        np.savez(buf, inds=pc.inds, vals=pc.vals)
        return buf.getvalue()

    def publish_vocab(self, pc: ParsedChunk) -> Optional[str]:
        """Publish this chunk's vocab delta atomically; returns the
        content sha the journal record names, or None when no mode is
        vocab-mapped.  The ``ingest.vocab`` fault site: a raised fault
        aborts this chunk's commit BEFORE anything was journaled, so
        the watermark never moves and a resume re-commits cleanly."""
        from splatt_tpu_torch.utils import faults
        from splatt_tpu_torch.utils.durable import publish_bytes

        data = self.vocab_bytes(pc)
        if data is None:
            return None
        faults.maybe_fail("ingest.vocab")
        publish_bytes(_vocab_path(self.dest, pc.n), data)
        return _sha(data)

    def publish_segment(self, pc: ParsedChunk) -> str:
        """Publish this chunk's COO segment atomically; returns its
        content sha."""
        from splatt_tpu_torch.utils.durable import publish_bytes

        data = self.segment_bytes(pc)
        publish_bytes(_segment_path(self.dest, pc.n), data)
        return _sha(data)

    def chunk_record(self, pc: ParsedChunk, seg_sha: str,
                     vocab_sha: Optional[str]) -> dict:
        rec = {"rec": REC_CHUNK, "n": pc.n, "lo": pc.lo, "hi": pc.hi,
               "line_hi": pc.line_hi,
               "records": pc.records, "nnz": int(pc.vals.size),
               "quarantined": pc.quarantined, "sha": pc.sha,
               "seg_sha": seg_sha, "vocab_sha": vocab_sha,
               "ts": time.time()}
        if pc.n == 0:
            rec["policy"] = {"nmodes": self.nmodes,
                             "vocab_modes": list(self.vocab_modes)}
        return rec

    def append_journal(self, rec: dict) -> None:
        """The watermark fence: the chunk record lands LAST, durably.
        The ``ingest.commit`` fault site fires before the append — a
        raised fault leaves published segment/vocab debris but NO
        journal record, so the chunk re-commits on resume (the
        exactly-once invariant's whole point)."""
        from splatt_tpu_torch.utils import faults
        from splatt_tpu_torch.utils.durable import append_line

        faults.maybe_fail("ingest.commit")
        append_line(_journal_path(self.dest),
                    json.dumps(rec, sort_keys=True).encode())

    def advance(self, pc: ParsedChunk, rec: dict) -> None:
        """In-memory watermark advance + the observable evidence
        (``watermark_advanced`` event, counters, gauge) — AFTER the
        journal append, mirroring what a resume would re-derive."""
        from splatt_tpu_torch import resilience, trace

        self.watermark = pc.n
        self.resume_offset = pc.hi
        self.nnz_total += int(pc.vals.size)
        self.records_total += pc.records
        self.quarantined_total += pc.quarantined
        for m in range(self.nmodes):
            if pc.inds.shape[1]:
                self.max_index[m] = max(self.max_index[m],
                                        int(pc.inds[m].max()))
        trace.metric_inc("splatt_ingest_chunks_total",
                         outcome="committed")
        trace.metric_inc("splatt_ingest_records_total",
                         float(pc.vals.size), outcome="committed")
        trace.metric_set("splatt_ingest_watermark",
                         float(self.watermark))
        resilience.run_report().add(
            "watermark_advanced", chunk=pc.n, nnz=int(pc.vals.size),
            records=pc.records, quarantined=pc.quarantined,
            offset=pc.hi, total_nnz=self.nnz_total)

    def commit_chunk(self, rc: RawChunk) -> dict:
        """One exactly-once chunk commit in fence order: parse +
        quarantine sidecar appends, vocab delta publish, segment publish,
        journal append LAST, then the in-memory advance."""
        from splatt_tpu_torch import trace

        with trace.span("ingest.chunk", n=rc.n) as sp:
            pc = self.parse_chunk(rc)
            vocab_sha = self.publish_vocab(pc)
            seg_sha = self.publish_segment(pc)
            rec = self.chunk_record(pc, seg_sha, vocab_sha)
            self.append_journal(rec)
            self.advance(pc, rec)
            sp.set(nnz=int(pc.vals.size), quarantined=pc.quarantined)
        return rec

    # -- finalize ------------------------------------------------------------

    def final_dims(self) -> Tuple[int, ...]:
        """Declared dims always win — on vocab modes too (parse_chunk
        quarantines any record that would grow a vocabulary past its
        declared dim, so indices stay in range); otherwise the vocab
        cardinality or the observed max index decides."""
        dims = []
        for m in range(self.nmodes or 0):
            if self.dims is not None:
                dims.append(self.dims[m])
            elif self.vocab_modes[m]:
                dims.append(len(self.vocab[m]))
            else:
                dims.append(self.max_index[m] + 1)
        return tuple(dims)

    def finalize(self) -> dict:
        """Assemble the committed segments into the memmap binary
        layout (io.py SPTT format), publish it atomically, and
        journal the finalize record.  Idempotent: a resume of an
        already-finalized run verifies the existing ``tensor.bin``
        against the journaled sha instead of rebuilding."""
        from splatt_tpu_torch import resilience, trace
        from splatt_tpu_torch.coo import SparseTensor
        from splatt_tpu_torch.io import _save_binary
        from splatt_tpu_torch.utils.durable import append_line, publish_file

        binp = _bin_path(self.dest)
        if self.finalized is not None:
            try:
                with open(binp, "rb") as f:
                    if _sha(f.read()) == self.finalized.get("bin_sha"):
                        return self.finalized
            except OSError:
                pass  # journaled finalize but torn/missing bin: rebuild
        if self.nmodes is None:
            raise IngestError(
                f"{self.source}: nothing committed — empty tensor "
                f"stream")
        parts_i = []
        parts_v = []
        for n in range(self.watermark + 1):
            inds, vals = load_segment(self.dest, n)
            parts_i.append(inds)
            parts_v.append(vals)
        inds = np.concatenate(parts_i, axis=1) if parts_i else \
            np.zeros((self.nmodes, 0), dtype=np.int64)
        vals = np.concatenate(parts_v) if parts_v else \
            np.zeros((0,), dtype=np.float64)
        dims = self.final_dims()
        tt = SparseTensor(np.ascontiguousarray(inds),
                          np.ascontiguousarray(vals), dims)
        tmp = f"{binp}.~{os.getpid()}.build"
        _save_binary(tt, tmp)
        with open(tmp, "rb") as f:
            bin_sha = _sha(f.read())
        publish_file(tmp, binp)
        rec = {"rec": REC_FINALIZE, "chunks": self.watermark + 1,
               "nnz": int(tt.nnz), "dims": [int(d) for d in dims],
               "bin_sha": bin_sha, "ts": time.time()}
        append_line(_journal_path(self.dest),
                    json.dumps(rec, sort_keys=True).encode())
        self.finalized = rec
        cards = {str(m): (len(self.vocab[m]) if self.vocab_modes[m]
                          else dims[m])
                 for m in range(self.nmodes)}
        resilience.run_report().add(
            "vocab_stats", dest=self.dest,
            vocab_modes=",".join(str(m) for m in range(self.nmodes)
                                 if self.vocab_modes[m]) or "none",
            cardinalities=",".join(f"{m}:{c}"
                                   for m, c in sorted(cards.items())),
            nnz=int(tt.nnz))
        trace.metric_set("splatt_ingest_watermark",
                         float(self.watermark))
        return rec


def load_segment(dest: str, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Read one committed chunk segment → (inds (m, k), vals (k,))."""
    with np.load(_segment_path(dest, n)) as z:
        return np.asarray(z["inds"]), np.asarray(z["vals"])


def assemble_delta(dest: str, lo_chunk: int, hi_chunk: int,
                   dims: Tuple[int, ...], out_path: str):
    """Build a delta COO tensor from committed chunks [lo, hi] and
    save it in the binary layout — the bridge from a watermark
    interval to a serve ``update`` job (serve.py _run_ingest)."""
    from splatt_tpu_torch.coo import SparseTensor
    from splatt_tpu_torch.io import _save_binary
    from splatt_tpu_torch.utils.durable import publish_file

    parts_i, parts_v = [], []
    for n in range(lo_chunk, hi_chunk + 1):
        inds, vals = load_segment(dest, n)
        parts_i.append(inds)
        parts_v.append(vals)
    inds = np.concatenate(parts_i, axis=1)
    vals = np.concatenate(parts_v)
    tt = SparseTensor(np.ascontiguousarray(inds),
                      np.ascontiguousarray(vals),
                      tuple(int(d) for d in dims))
    tmp = f"{out_path}.~{os.getpid()}.build"
    _save_binary(tt, tmp)
    publish_file(tmp, out_path)
    return tt


# -- the streaming driver (backpressure + the public entry point) ------------


def ingest_stream(source: str, dest: str, fmt: str = "auto",
                  chunk_records: Optional[int] = None,
                  dims: Optional[Tuple[int, ...]] = None,
                  quarantine_max: Optional[int] = None,
                  quarantine_rate: Optional[float] = None,
                  inflight: Optional[int] = None,
                  stop: Optional[Callable[[], bool]] = None,
                  on_watermark: Optional[Callable[["IngestState", dict],
                                                  None]] = None) -> dict:
    """Ingest one record stream end-to-end: resume-aware open, a
    bounded reader thread (backpressure), exactly-once chunk commits,
    finalize into ``<dest>/tensor.bin``.

    Returns the run summary dict (``status`` is ``converged`` or —
    when the quarantine budget tripped — ``degraded``; committed
    chunks survive either way and a re-run resumes from the
    watermark).  ``on_watermark(state, chunk_record)`` fires after
    every commit — the serve ingest job's update-emission hook."""
    import contextvars

    from splatt_tpu_torch import resilience, trace
    from splatt_tpu_torch.utils.env import read_env_int

    t0 = time.time()
    os.makedirs(dest, exist_ok=True)
    st = IngestState(source, dest, fmt=fmt, chunk_records=chunk_records,
                     dims=dims, quarantine_max=quarantine_max,
                     quarantine_rate=quarantine_rate)
    depth = int(inflight or read_env_int("SPLATT_INGEST_INFLIGHT"))
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    _DONE = object()
    abort = threading.Event()

    def _put(item) -> bool:
        """Bounded put that yields to the abort signal: when the
        committer exits early (degraded run, on_watermark raise) the
        reader must never block forever against a full queue — that
        leaks the thread AND the open source fd for the daemon's
        lifetime."""
        while not abort.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _reader():
        try:
            for rc in st.read_chunks(stop=stop):
                if not _put(rc):
                    return
            _put(_DONE)
        except BaseException as e:
            _put(e)

    status = "converged"
    degrade_error = None
    with trace.span("ingest.run", source=os.path.basename(source),
                    resumed=st.resumed) as sp:
        ctx = contextvars.copy_context()
        reader = threading.Thread(target=ctx.run, args=(_reader,),
                                  name="splatt-ingest-reader",
                                  daemon=True)
        reader.start()
        try:
            while True:
                item = q.get()
                if item is _DONE:
                    break
                if isinstance(item, BaseException):
                    raise item
                try:
                    rec = st.commit_chunk(item)
                except IngestDegraded as e:
                    # the quarantine budget: stop CLASSIFIED with the
                    # committed watermark intact — degraded, not lost.
                    # The failing chunk's sidecar appends already
                    # happened durably, so fold its pending count in:
                    # the summary must account the very records that
                    # tripped the budget
                    st.quarantined_total += getattr(st, "_q_pending", 0)
                    st._q_pending = 0
                    cls = resilience.classify_failure(e)
                    resilience.run_report().add(
                        "ingest_degraded", dest=dest,
                        watermark=st.watermark,
                        quarantined=st.quarantined_total,
                        failure_class=cls.value,
                        error=resilience.failure_message(e)[:200])
                    status = "degraded"
                    degrade_error = resilience.failure_message(e)[:200]
                    break
                if on_watermark is not None:
                    on_watermark(st, rec)
        finally:
            # stop the reader, then drain UNTIL it joins: one drain
            # pass is not enough — a long remaining stream refills the
            # bounded queue and a put()-blocked daemon thread would
            # hold the open source fd forever
            abort.set()
            deadline = time.monotonic() + 10.0
            while reader.is_alive():
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
                reader.join(timeout=0.2)
                if time.monotonic() > deadline:
                    break
        stopped = stop is not None and stop()
        final = None
        if status == "converged" and not stopped \
                and st.watermark >= 0:
            final = st.finalize()
        sp.set(status=status, chunks=st.watermark + 1,
               nnz=st.nnz_total)
    dt = max(time.time() - t0, 1e-9)
    return {
        "status": status, "source": os.path.abspath(source),
        "dest": os.path.abspath(dest), "format": st.fmt,
        "chunks": st.watermark + 1, "watermark": st.watermark,
        "records": st.records_total, "nnz": st.nnz_total,
        "quarantined": st.quarantined_total, "resumed": st.resumed,
        "stopped": bool(stopped),
        "dims": ([int(d) for d in st.final_dims()]
                 if st.nmodes is not None else None),
        "tensor": (_bin_path(dest) if final is not None else None),
        "records_per_sec": round(st.records_total / dt, 1),
        "error": degrade_error,
    }
