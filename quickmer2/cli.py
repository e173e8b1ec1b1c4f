"""Command-line interface mirroring the reference's subcommands
(QuicKmer.c:1496-1519) plus the Python post-processing utilities.

  python -m quickmer2 search [-k N] [-s SIZE] [-e N] [-d N] [-w N]
                                 [-c ctrl.bed] [--quirk-editdist] ref.fa
  python -m quickmer2 count  [--mode anchored] [--data-devices N]
                                 [--checkpoint PATH] [--json] ref.fa sample out
  python -m quickmer2 cohort [--mode anchored] ref.fa s1.fq:out1 ...
  python -m quickmer2 est    ref.fa sample_prefix out.bed [--plot]
  python -m quickmer2 sparse [-w N] [-c ctrl.bed] bp ref.fa
  python -m quickmer2 index  [-s SIZE] kmers.bed out.qm
  python -m quickmer2 colortrack --cn cn.bed --name SAMPLE
  python -m quickmer2 colorkey [out.bed]

Flag semantics follow the reference: -s accepts K/M/G suffixes and
rounds up to a power of two; count auto-detects FASTQ by a leading '@';
-t is accepted for parity but parallelism is configured via device mesh.
"""

from __future__ import annotations

import argparse
import sys

from quickmer2.config import CountConfig, EstConfig, SearchConfig, parse_size_suffix


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="quickmer2",
                                description="k-mer copy-number engine")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("search", help="build a unique-k-mer dictionary from a genome")
    s.add_argument("-k", type=int, default=30, help="k-mer size (3-32, default 30)")
    s.add_argument("-t", type=int, default=1, help="threads (CLI parity; unused)")
    s.add_argument("-s", type=str, default="32M", help="hash size (K/M/G suffix ok)")
    s.add_argument("-e", type=int, default=2, help="edit distance 0-2")
    s.add_argument("-d", type=int, default=100, help="edit depth threshold")
    s.add_argument("-w", type=int, default=1000, help="k-mers per window")
    s.add_argument("-c", type=str, default=None, help="control region bed")
    s.add_argument("--quirk-editdist", action="store_true",
                   help="bit-exact emulation of the reference's mod-32 "
                        "edit filter (SURVEY.md Q2)")
    s.add_argument("--out-prefix", type=str, default=None)
    s.add_argument("--json", action="store_true",
                   help="print structured per-phase stats as one JSON line")
    s.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write an xprof/TensorBoard trace of the run to DIR")
    s.add_argument("--emit-devices", type=int, default=None,
                   help="genome-shard the pass-2 membership scan over N "
                        "devices (k-1 halos; bit-identical artifacts)")
    s.add_argument("fasta")

    c = sub.add_parser("count", help="count k-mer depth from sample reads")
    c.add_argument("-t", type=int, default=1, help="threads (CLI parity)")
    c.add_argument("--batch-bases", type=int, default=1 << 24)
    c.add_argument("--mode", choices=["flat", "anchored"], default="flat",
                   help="anchored = genome-anchored fast path (needs the "
                        "reference FASTA next to the .qm); bit-identical "
                        "output to flat")
    c.add_argument("--read-len", type=int, default=None,
                   help="fixed read length for anchored mode (autodetected)")
    c.add_argument("--data-devices", type=int, default=None,
                   help="shard the count over N local devices "
                        "(bit-identical output)")
    c.add_argument("--dict-devices", type=int, default=None,
                   help="bucket-block-shard the dictionary over N local "
                        "devices (tables larger than one HBM; "
                        "bit-identical output)")
    c.add_argument("--checkpoint", type=str, default=None, metavar="PATH",
                   help="periodic resume checkpoint; rerun with the same "
                        "flags to resume (works for stdin too: the "
                        "replayed pipe is fast-forwarded)")
    c.add_argument("--checkpoint-every", type=parse_size_suffix,
                   default=1 << 30, metavar="BYTES",
                   help="checkpoint interval in consumed bytes "
                        "(K/M/G suffix ok, default 1G)")
    c.add_argument("--engine", choices=["mono", "packed", "sortjoin",
                                       "linear", "auto"], default="mono",
                   help="flat-path exact engine; auto picks sortjoin for "
                        "small dictionaries (no scatter wall) else mono")
    c.add_argument("--json", action="store_true",
                   help="print the run's structured stats as one JSON "
                        "line on stdout")
    c.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write an xprof/TensorBoard trace of the run "
                        "(per-kernel device timing) to DIR")
    c.add_argument("fasta", help="reference FASTA path or .qm path")
    c.add_argument("sample", help="FASTA/FASTQ reads ('-' for stdin)")
    c.add_argument("out_prefix")

    co = sub.add_parser("cohort", help="count+est many samples against "
                                       "one dictionary (amortized load)")
    co.add_argument("--batch-bases", type=int, default=1 << 24)
    co.add_argument("--mode", choices=["flat", "anchored"], default="flat")
    co.add_argument("--read-len", type=int, default=None)
    co.add_argument("--data-devices", type=int, default=None)
    co.add_argument("--dict-devices", type=int, default=None,
                    help="bucket-block-shard the dictionary over N local "
                         "devices (bit-identical output)")
    co.add_argument("--json", action="store_true")
    co.add_argument("fasta", help="reference FASTA path or .qm path")
    co.add_argument("pairs", nargs="+",
                    help="sample.fq:out_prefix pairs (est runs when the "
                         ".qgc companion exists)")

    e = sub.add_parser("est", help="GC-corrected copy-number estimation")
    e.add_argument("--plot", action="store_true", help="write QC png")
    e.add_argument("--json", action="store_true",
                   help="print structured per-phase stats as one JSON line")
    e.add_argument("fasta", help="reference FASTA path (for .qgc/.bed)")
    e.add_argument("sample_prefix")
    e.add_argument("out_bed")

    sp = sub.add_parser("sparse", help="thin a dictionary / regenerate companions")
    sp.add_argument("-w", type=int, default=1000)
    sp.add_argument("-c", type=str, default=None)
    sp.add_argument("bp", type=int)
    sp.add_argument("fasta")

    ix = sub.add_parser("index", help="build a .qm from a k-mer bed list")
    ix.add_argument("-k", type=int, default=30, help="(overridden by row length)")
    ix.add_argument("-s", type=str, default="32M")
    ix.add_argument("bed")
    ix.add_argument("out_qm")

    ct = sub.add_parser("colortrack", help="CN bed → UCSC color track")
    ct.add_argument("--cn", required=True)
    ct.add_argument("--name", required=True)

    ck = sub.add_parser("colorkey", help="write the color legend bed")
    ck.add_argument("out", nargs="?", default="color-track.bed")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.cmd == "search":
        import json
        from quickmer2.pipelines.search import run_search
        cfg = SearchConfig(kmer_size=args.k, threads=args.t,
                           hash_size=parse_size_suffix(args.s),
                           edit_distance=args.e, edit_depth_threshold=args.d,
                           window_size=args.w, control_bed=args.c,
                           quirk_mod32_editdist=args.quirk_editdist)
        stats = {}
        from quickmer2.utils.profiling import trace
        with trace(args.profile):
            run_search(args.fasta, cfg, out_prefix=args.out_prefix,
                       verbose=not args.json, stats=stats,
                       emit_devices=args.emit_devices)
        if args.json:
            print(json.dumps(stats))

    elif args.cmd == "count":
        import json
        from quickmer2.pipelines.count import run_count
        qm = args.fasta if args.fasta.endswith(".qm") else args.fasta + ".qm"
        from quickmer2.utils.profiling import trace
        with trace(args.profile):
            stats = run_count(
                qm, args.sample, args.out_prefix,
                batch_bases=args.batch_bases, mode=args.mode,
                ref_fasta=args.fasta if args.mode == "anchored" else None,
                read_len=args.read_len, data_devices=args.data_devices,
                dict_devices=args.dict_devices,
                checkpoint_path=args.checkpoint,
                checkpoint_every_bytes=args.checkpoint_every,
                engine=args.engine,
                verbose=not args.json)
        if args.json:
            print(json.dumps(stats))

    elif args.cmd == "cohort":
        import json
        from quickmer2.pipelines.cohort import run_cohort
        qm = args.fasta if args.fasta.endswith(".qm") else args.fasta + ".qm"
        pairs = []
        for p in args.pairs:
            sample, _, out = p.rpartition(":")
            if not sample:
                raise SystemExit(f"cohort pair {p!r} must be sample:out_prefix")
            pairs.append((sample, out))
        stats = run_cohort(qm, pairs, batch_bases=args.batch_bases,
                           mode=args.mode,
                           ref_fasta=args.fasta if args.mode == "anchored"
                           else None,
                           read_len=args.read_len,
                           data_devices=args.data_devices,
                           dict_devices=args.dict_devices,
                           verbose=not args.json)
        if args.json:
            print(json.dumps(stats))

    elif args.cmd == "est":
        import json
        from quickmer2.pipelines.est import run_est
        res = run_est(args.fasta, args.sample_prefix, args.out_bed,
                      verbose=not args.json)
        if args.json:
            print(json.dumps({k: v for k, v in res.items()
                              if k != "factors"}))
        if args.plot:
            from quickmer2.analytics import plots
            if plots.available():
                plots.gc_qc_plot(args.sample_prefix + ".txt", res["factors"])
            else:
                print("matplotlib unavailable; skipping QC plot", file=sys.stderr)

    elif args.cmd == "sparse":
        from quickmer2.pipelines.sparse import run_sparse
        run_sparse(args.fasta, args.bp, window_size=args.w, control_bed=args.c)

    elif args.cmd == "index":
        from quickmer2.pipelines.index import run_index
        run_index(args.bed, args.out_qm, hash_size=parse_size_suffix(args.s))

    elif args.cmd == "colortrack":
        from quickmer2.analytics.colortrack import make_colortrack
        out = make_colortrack(args.cn, args.name)
        print(f"wrote {out}")

    elif args.cmd == "colorkey":
        from quickmer2.analytics.colortrack import write_color_key
        print(f"wrote {write_color_key(args.out)}")

    return 0


if __name__ == "__main__":
    raise SystemExit(main())
