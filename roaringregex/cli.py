"""rrx — grep-style CLI over the batched device engine.

The L4 layer of SURVEY.md §7.1 and the analog of the reference's test
driver (src/test/main.cpp:17-31: reads text+pattern, prints NFA dump,
verdict, wall time), grown into a usable tool:

    python -m roaringregex.cli PATTERN [FILE...]      # matching lines
    ... -c / --count        count matching lines only
    ... -n / --line-number  prefix line numbers
    ... -o / --only-spans   print span offsets instead of lines
    ... --fullmatch         whole-line acceptance (the reference's semantics)
    ... --dump              print the compiled NFA (NFA::print analog)
    ... --stats             matches/lines/bytes + wall time to stderr
    ... --backend {pallas,packed,xla}

Reads stdin when no FILE is given. Lines are batched and scanned
data-parallel on the device; bytes >= 0x80 are treated as dead symbols
(the engine is ASCII-only, like the reference: NFA.cc:25).
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Iterable, List, Tuple

import numpy as np


def _read_buffers(paths: List[str]) -> Iterable[Tuple[str, bytes]]:
    if not paths:
        yield "(stdin)", sys.stdin.buffer.read()
        return
    for p in paths:
        try:
            with open(p, "rb") as f:
                yield p, f.read()
        except OSError as e:
            raise SystemExit(f"rrx: {p}: {e.strerror}")


def pack_buffer(buf: bytes, G: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Newline-split + pad a corpus buffer: native data-loader when built
    (native/rrx_host.cc), Python fallback otherwise. L is sized by the
    longest record, so a single huge line inflates the whole batch."""
    from .compiler.native import pack_corpus_native

    r = pack_corpus_native(buf, G)
    if r is not None:
        return r
    lines = buf.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    B = len(lines)
    Bp = max(G, ((B + G - 1) // G) * G)
    L = max(16, 1 << (max((len(b) for b in lines), default=1) or 1).bit_length())
    data = np.zeros((Bp, L), np.uint8)
    lengths = np.zeros(Bp, np.int32)
    for i, b in enumerate(lines):
        data[i, : len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
    return data, lengths, B



def _stream_sources(args):
    """(name, binary fileobj) pairs for --stream: stdin or each FILE."""
    import sys

    if not args.files:
        yield "(stdin)", sys.stdin.buffer
    else:
        for p in args.files:
            try:
                f = open(p, "rb")
            except OSError as e:
                raise SystemExit(f"rrx: {p}: {e.strerror}")
            with f:
                yield p, f


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="rrx", description="POSIX-ERE grep on the GPU"
    )
    ap.add_argument("pattern", nargs="?")
    ap.add_argument("files", nargs="*")
    ap.add_argument(
        "-e", "--regexp", action="append", default=[],
        help="pattern (repeatable; multiple patterns scan in ONE pass)",
    )
    ap.add_argument("-c", "--count", action="store_true")
    ap.add_argument("-n", "--line-number", action="store_true")
    ap.add_argument("-o", "--only-spans", action="store_true")
    ap.add_argument("-v", "--invert-match", action="store_true")
    ap.add_argument("--fullmatch", action="store_true")
    ap.add_argument(
        "--greedy", action="store_true",
        help="-o spans use the greedy (POSIX leftmost-longest) policy",
    )
    ap.add_argument(
        "--long", action="store_true",
        help="scan each FILE as ONE string (block-parallel long-string mode)",
    )
    ap.add_argument(
        "--stream", action="store_true",
        help="out-of-core line grep: chunked host->device pipelined scan "
        "(corpora larger than HBM; stdin or FILEs of any size)",
    )
    ap.add_argument("--dump", action="store_true")
    ap.add_argument(
        "--dump-full", action="store_true",
        help="--dump plus per-state per-symbol fwd+bwd transition rows",
    )
    ap.add_argument("--stats", action="store_true")
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)

    patterns = list(args.regexp)
    if args.pattern is not None:
        if patterns:
            args.files = [args.pattern] + args.files  # pattern slot is a file
        else:
            patterns = [args.pattern]
    if not patterns:
        print("rrx: no pattern given (use PATTERN or -e)", file=sys.stderr)
        return 2
    if len(patterns) > 1 and (args.only_spans or args.fullmatch or args.dump or args.dump_full):
        print("rrx: -o/--fullmatch/--dump take a single pattern", file=sys.stderr)
        return 2
    if args.only_spans and (args.invert_match or args.fullmatch):
        # GNU grep prints nothing for -o -v; -o under --fullmatch would lie
        # (lazy spans != the fullmatch span). Reject loudly instead.
        print("rrx: -o cannot be combined with -v or --fullmatch",
              file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    n_match = 0
    n_lines = 0
    n_bytes = 0
    many_files = len(args.files) > 1
    counts_only = args.count

    if args.backend == "host":
        # Self-contained native CPU scan (native/rrx_host.cc RrxScanner):
        # no JAX/device runtime is initialized at all on this path — the
        # librregex.a capability of the reference.
        if args.long:
            print("rrx: --backend host has no --long mode", file=sys.stderr)
            return 2
        from .compiler.native import HostEngine
        from .compiler.nfa import PatternTooLargeError
        from .compiler.parser import RegexSyntaxError

        try:
            engines = [HostEngine(p) for p in patterns]
        except (RegexSyntaxError, PatternTooLargeError) as e:
            print(f"rrx: invalid pattern: {e}", file=sys.stderr)
            return 2
        he = engines[0]
        if args.dump or args.dump_full:
            # program compile + dump are pure host numpy (no ScanEngine)
            from .compiler.serialize import cached_compile

            print(cached_compile(patterns[0]).nfa.dump(full=args.dump_full))
            if not args.files and sys.stdin.isatty():
                return 0
        for src, buf in _read_buffers(args.files):
            lines = buf.split(b"\n")
            if lines and lines[-1] == b"":
                lines.pop()
            n_lines += len(lines)
            line_hits = None
            if not args.fullmatch and (not args.only_spans or counts_only):
                # whole-buffer grep, one native call per pattern (early
                # exit per line); multi-pattern = grep-style union.
                # -o -c needs only the per-line hit bit too
                line_hits = engines[0].grep_lines(buf)
                for eng in engines[1:]:
                    line_hits |= eng.grep_lines(buf)
            for ln_no, line in enumerate(lines):
                n_bytes += len(line)
                spans = None
                if line_hits is not None:
                    hit = bool(line_hits[ln_no])
                elif args.only_spans:
                    spans = he.finditer(line, longest=args.greedy)
                    hit = bool(spans)
                else:
                    hit = he.fullmatch(line)
                if args.invert_match:
                    hit = not hit
                if hit:
                    n_match += 1
                    if not counts_only:
                        prefix = f"{src}:" if many_files else ""
                        if args.line_number:
                            prefix += f"{ln_no + 1}:"
                        if spans is not None:
                            body = " ".join(f"{s}-{e}" for s, e in spans)
                        else:
                            body = line.decode("ascii", "replace")
                        print(prefix + body)
        if counts_only:
            print(n_match)
        if args.stats:
            dt = time.perf_counter() - t0
            print(
                f"rrx: {n_match}/{n_lines} lines, {n_bytes} bytes, "
                f"{dt*1e3:.1f} ms (native host engine)",
                file=sys.stderr,
            )
        return 0 if n_match > 0 else 1

    from .api import MultiPattern, Pattern
    from .compiler.nfa import PatternTooLargeError
    from .compiler.parser import RegexSyntaxError

    multi = None
    try:
        if len(patterns) > 1:
            multi = MultiPattern(patterns, backend=args.backend)
            pat = None
        else:
            pat = Pattern(patterns[0], backend=args.backend)
    except (RegexSyntaxError, PatternTooLargeError) as e:
        print(f"rrx: invalid pattern: {e}", file=sys.stderr)
        return 2
    if args.dump or args.dump_full:
        print(pat.dump(full=args.dump_full))
        if not args.files and sys.stdin.isatty():
            return 0

    if args.stream:
        # out-of-core streaming grep: never materializes a whole FILE —
        # fixed-shape record chunks flow host->device with `depth` in
        # flight (roaringregex/stream.py)
        if args.fullmatch or args.long or args.invert_match:
            print(
                "rrx: --stream supports line grep (-c / -n / plain / -o)",
                file=sys.stderr,
            )
            return 2
        if args.only_spans and multi is not None:
            print("rrx: --stream -o takes a single pattern", file=sys.stderr)
            return 2
        from .stream import StreamScanner, iter_line_batches

        try:
            sc = StreamScanner(multi if multi is not None else pat.engine)
        except ValueError as e:
            print(f"rrx: {e}", file=sys.stderr)
            return 2

        if args.only_spans:
            # span offsets out-of-core: fixed-cap device span buffers per
            # chunk; records overflowing the cap re-run alone at their
            # exact span count (never silently truncate)
            cap = 32
            for src, f in _stream_sources(args):
                ln_no = 0
                try:
                    chunks = sc.spans_stream(
                        iter_line_batches(f), cap=cap, longest=args.greedy
                    )
                except ValueError as e:
                    print(f"rrx: {e}", file=sys.stderr)
                    return 2
                for s_b, e_b, c_b, over, data, lengths in chunks:
                    B = len(c_b)
                    n_lines += B
                    n_bytes += int(lengths.sum())
                    for i in np.nonzero(c_b > 0)[0]:
                        n_match += 1
                        if counts_only:
                            continue
                        prefix = f"{src}:" if many_files else ""
                        if args.line_number:
                            prefix += f"{ln_no + int(i) + 1}:"
                        if over[i]:
                            # rare cap overflow: exact re-run of just
                            # this record
                            line = bytes(data[int(i), : lengths[int(i)]])
                            pairs = pat.finditer_batch(
                                [line], longest=args.greedy
                            )[0]
                        else:
                            pairs = list(zip(
                                s_b[i, : c_b[i]].tolist(),
                                e_b[i, : c_b[i]].tolist(),
                            ))
                        print(
                            prefix + " ".join(f"{s}-{e}" for s, e in pairs)
                        )
                    ln_no += B
            if counts_only:
                print(n_match)
            if args.stats:
                dt = time.perf_counter() - t0
                print(
                    f"rrx: {n_match}/{n_lines} lines, {n_bytes} bytes, "
                    f"{dt*1e3:.1f} ms streamed spans",
                    file=sys.stderr,
                )
            return 0 if n_match > 0 else 1

        import collections as _c

        for src, f in _stream_sources(args):
            ln_no = 0
            nreal_q = _c.deque()  # real-line count per chunk, FIFO with
            # the pipeline's in-order retirement (phantom pad records at
            # the tail of a chunk are indistinguishable from real empty
            # lines by length alone)

            def gen(f=f):
                for d, l, nr in iter_line_batches(f):
                    nreal_q.append(nr)
                    yield d, l

            for hits, data, lengths in sc.hits_stream(gen()):
                B = nreal_q.popleft()
                n_lines += B
                n_bytes += int(lengths[:B].sum())
                idxs = np.nonzero(hits[:B])[0]
                n_match += len(idxs)
                if not counts_only:
                    for i in idxs:
                        prefix = f"{src}:" if many_files else ""
                        if args.line_number:
                            prefix += f"{ln_no + int(i) + 1}:"
                        line = bytes(data[int(i), : lengths[int(i)]])
                        print(prefix + line.decode("ascii", "replace"))
                ln_no += B
        if counts_only:
            print(n_match)
        if args.stats:
            dt = time.perf_counter() - t0
            print(
                f"rrx: {n_match}/{n_lines} lines, {n_bytes} bytes, "
                f"{dt*1e3:.1f} ms streamed "
                f"({n_bytes/max(dt,1e-9)/1e6:.1f} MB/s end-to-end)",
                file=sys.stderr,
            )
        return 0 if n_match > 0 else 1

    if args.long:
        if multi is not None:
            print("rrx: --long takes a single pattern", file=sys.stderr)
            return 2
        n_match = n_bytes = 0
        nsrc = 0
        for src, buf in _read_buffers(args.files):
            nsrc += 1
            n_bytes += len(buf)
            if args.only_spans:
                try:
                    spans = pat.finditer_long(buf, longest=args.greedy)
                except ValueError as e:
                    print(f"rrx: {e}", file=sys.stderr)
                    return 2
                n_match += len(spans)
                if not args.count:
                    print(f"{src}: " + " ".join(f"{s}-{e}" for s, e in spans))
                continue
            cnt = pat.long.count_ends(buf)
            n_match += cnt
            if not args.count:
                print(f"{src}: {cnt} match end(s)")
        if args.count:
            print(n_match)
        if args.stats:
            dt = time.perf_counter() - t0
            print(
                f"rrx: {n_match} ends in {nsrc} file(s), {n_bytes} bytes, "
                f"{dt*1e3:.1f} ms ({n_bytes/max(dt,1e-9)/1e6:.1f} MB/s)",
                file=sys.stderr,
            )
        return 0 if n_match > 0 else 1

    prog = (multi or pat).program
    for src, buf in _read_buffers(args.files):
        data, lengths, B = pack_buffer(buf, prog.G)
        n_lines += B
        n_bytes += int(lengths[:B].sum())
        if B == 0:
            continue
        if multi is not None:
            _, _, anym = multi.engine.match_stats(data, lengths, seeded=True)
            per = np.asarray(anym).reshape(-1, multi.P)[:B]
            if multi.nullables.any():
                per = per | multi.nullables[None, :]
            hits = per.any(axis=1)
        elif args.fullmatch:
            hits = pat.engine.fullmatch_flags(data, lengths)[:B]
        else:
            _, _, anym = pat.engine.match_stats(data, lengths, seeded=True)
            hits = np.asarray(anym)[:B]
        if args.invert_match:
            hits = ~hits
        idxs = np.nonzero(hits)[0]
        n_match += len(idxs)
        if counts_only:
            continue
        span_rows = None
        if args.only_spans and not args.invert_match:
            sel = [bytes(data[int(i), : lengths[int(i)]]) for i in idxs]
            span_rows = (
                pat.finditer_batch(sel, longest=args.greedy) if sel else []
            )
        for k, i in enumerate(idxs):
            prefix = f"{src}:" if many_files else ""
            if args.line_number:
                prefix += f"{int(i) + 1}:"
            if span_rows is not None:
                spans = " ".join(f"{s}-{e}" for s, e in span_rows[k])
                print(f"{prefix}{spans}")
            else:
                text = bytes(data[int(i), : lengths[int(i)]]).decode(
                    "ascii", "replace"
                )
                print(f"{prefix}{text}")

    if counts_only:
        print(n_match)
    if args.stats:
        dt = time.perf_counter() - t0
        print(
            f"rrx: {n_match}/{n_lines} lines matched, {n_bytes} bytes, "
            f"{dt*1e3:.1f} ms ({n_bytes/max(dt,1e-9)/1e6:.1f} MB/s), "
            f"tier={prog.tier} backend={(multi or pat).engine.backend}",
            file=sys.stderr,
        )
    return 0 if n_match > 0 else 1


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. piped into `head`
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(141)
