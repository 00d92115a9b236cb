"""CLI launcher — entry point parity with the reference.

Covers the reference's CLI surfaces (SURVEY §2.6): ``rag_launcher.py``'s
``--system/--storage/--port/--test/--interactive`` flags,
``run_integrated_rag.py``'s ``--cli/--daemon/--init-only`` modes and its
REPL (``help/status/stats/query <q>`` + free text), and the per-module
``--test`` smoke modes (``embedding_pipeline.py:865-889`` pattern).

Every mode builds the system on ``--device`` (default ``cuda``; without
a card it raises unless given ``--device cpu``).

Usage:
    python -m modular_rag_system_tpu_torch.launcher --test
    python -m modular_rag_system_tpu_torch.launcher --cli
    python -m modular_rag_system_tpu_torch.launcher --query "what is X"
    python -m modular_rag_system_tpu_torch.launcher --daemon
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

from modular_rag_system_tpu_torch.config import RAGConfig


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rag-tpu-torch",
        description="RAG framework launcher (PyTorch port)",
    )
    p.add_argument("--config", default=None, help="path to JSON config overlay")
    p.add_argument("--storage", default=None, help="storage path override")
    p.add_argument("--port", type=int, default=None, help="file-server port override")
    p.add_argument("--tier", default=None, choices=["exact", "fused", "bf16", "int8", "ivf"],
                   help="index tier override")
    p.add_argument("--encoder", default=None, choices=["auto", "minilm", "fake"],
                   help="encoder override")
    p.add_argument("--shards", type=int, default=None,
                   help="index shards, one card each (cuda:0 .. cuda:N-1); "
                        "with --device cpu, N shards on the CPU")
    p.add_argument("--multihost", action="store_true",
                   help="multi-host index layout: join a gloo process group "
                        "(RAG_COORDINATOR / RAG_NUM_PROCESSES / RAG_PROCESS_ID, "
                        "else torchrun's variables); each process holds its "
                        "slice of the index's shards")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (default cuda; cpu on "
                        "request, never as a fallback)")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--cli", action="store_true", help="interactive REPL")
    mode.add_argument("--gui", action="store_true", help="Tkinter GUI (needs a display)")
    mode.add_argument("--daemon", action="store_true", help="serve until interrupted")
    mode.add_argument("--init-only", action="store_true", help="initialize and exit")
    mode.add_argument("--test", action="store_true", help="run the self-test smoke mode")
    mode.add_argument("--interactive", action="store_true",
                      help="interactive menu (reference rag_launcher parity)")
    mode.add_argument("--query", default=None, help="run one query and exit")
    p.add_argument("--stats", action="store_true", help="print stats after the action")
    return p


def load_config(args) -> RAGConfig:
    overrides = {}
    if args.storage:
        overrides["store.storage_path"] = args.storage
    if args.port is not None:
        overrides["serving.file_server_port"] = args.port
    if args.tier:
        overrides["index.tier"] = args.tier
    if args.encoder:
        overrides["embedding.model"] = args.encoder
    if args.shards is not None:
        overrides["mesh.index_shards"] = args.shards
    if args.multihost:
        overrides["mesh.multihost"] = True
    return RAGConfig.load(args.config, overrides=overrides, write_default=bool(args.config))


def _build_system(cfg: RAGConfig, device: str):
    from modular_rag_system_tpu_torch.facade import EnhancedRAGSystem

    return EnhancedRAGSystem(cfg, device=device)


# ---------------------------------------------------------------------------
def run_self_test(cfg: RAGConfig, device: str = "cuda") -> int:
    """--test: end-to-end smoke covering ingest, query, files, stats

    (the reference's per-module self-test UX, e.g.
    ``embedding_pipeline.py:865-889``)."""
    print("rag-tpu-torch self-test")
    sys_ = _build_system(cfg, device)
    try:
        t0 = time.time()
        ids = sys_.engine.add_text(
            "The TPU framework self test document. It mentions retrieval, "
            "embeddings and indexes.\n\nSecond paragraph about queries.",
            source="self-test",
        )
        print(f"  ingest: {len(ids)} chunks in {time.time()-t0:.2f}s")
        res = sys_.engine.query("retrieval embeddings", max_results=3,
                                similarity_threshold=0.0)
        ok_query = bool(res.documents)
        print(f"  query: {len(res.documents)} results "
              f"({res.retrieval_time*1000:.1f} ms) -> {'OK' if ok_query else 'FAIL'}")
        port = sys_.files.start_web_server()
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{port}/files", timeout=5) as r:
            ok_files = r.status == 200
        print(f"  file server on :{port} -> {'OK' if ok_files else 'FAIL'}")
        eq = sys_.enhanced_query("what does the self test mention?")
        ok_enh = "insight" in eq
        print(f"  enhanced_query (type={eq['query_type']}, "
              f"confidence={eq['confidence']}) -> {'OK' if ok_enh else 'FAIL'}")
        stats = sys_.get_system_stats()
        print(f"  stats: {stats['engine']['index']['count']} docs, "
              f"tier={stats['engine']['index']['tier']}, "
              f"encoder={stats['engine']['encoder']}")
        passed = ok_query and ok_files and ok_enh
        print("self-test:", "PASSED" if passed else "FAILED")
        return 0 if passed else 1
    finally:
        sys_.shutdown()


def run_repl(cfg: RAGConfig, device: str = "cuda") -> int:
    """--cli REPL (reference ``run_integrated_rag.py:366-425``)."""
    sys_ = _build_system(cfg, device)
    sys_.start()
    print("rag-tpu-torch REPL. Commands: help | status | stats | query <text> | quit")
    try:
        while True:
            try:
                line = input("rag> ").strip()
            except (EOFError, KeyboardInterrupt):
                break
            if not line:
                continue
            if line in ("quit", "exit"):
                break
            if line == "help":
                print("help | status | stats | query <text> | feedback <pos|neg> | quit")
            elif line == "status":
                st = sys_.get_system_stats()
                print(f"docs={st['engine']['index']['count']} "
                      f"tier={st['engine']['index']['tier']} "
                      f"encoder={st['engine']['encoder']} "
                      f"files={st['files']['count']} started={st['started']}")
            elif line == "stats":
                print(json.dumps(sys_.get_system_stats(), indent=2, default=str))
            else:
                qtext = line[6:] if line.startswith("query ") else line
                resp = sys_.enhanced_query(qtext)
                print(resp["insight"])
                print(f"[confidence={resp['confidence']} type={resp['query_type']} "
                      f"{'cache' if resp['from_cache'] else 'fresh'}]")
        return 0
    finally:
        sys_.shutdown()


def run_interactive_menu(cfg: RAGConfig, device: str = "cuda") -> int:
    """Interactive launcher menu (reference ``rag_launcher.py:interactive_menu``)."""
    options = {
        "1": ("Run the self-test", run_self_test),
        "2": ("Start the CLI REPL", run_repl),
        "3": ("Start the daemon (file + query APIs)", run_daemon),
        "4": ("Launch the GUI", run_gui),
        "q": ("Quit", None),
    }
    while True:
        print("\nrag-tpu-torch launcher")
        for key, (label, _fn) in options.items():
            print(f"  {key}) {label}")
        try:
            choice = input("> ").strip().lower()
        except (EOFError, KeyboardInterrupt):
            return 0
        if choice == "q":
            return 0
        entry = options.get(choice)
        if entry is None:
            print("unknown choice")
            continue
        rc = entry[1](cfg, device)
        if choice != "1":
            return rc
        print(f"(self-test exit code {rc})")


def run_daemon(cfg: RAGConfig, device: str = "cuda") -> int:
    import signal

    from modular_rag_system_tpu_torch.serving import RAGHTTPServer

    sys_ = _build_system(cfg, device)
    sys_.start()
    # graceful SIGTERM (reference keystroke_logger.py installed
    # SIGINT/SIGTERM handlers; a daemon must die cleanly under systemd)
    signal.signal(signal.SIGTERM, lambda *_: (_ for _ in ()).throw(KeyboardInterrupt))
    api = RAGHTTPServer(sys_, port=cfg.serving.file_server_port + 1
                        if cfg.serving.file_server_port else 0)
    api_port = api.start()
    print(f"rag-tpu-torch daemon: files :{sys_.files.port}, query API :{api_port}; "
          f"Ctrl-C to stop", flush=True)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        return 0
    finally:
        api.stop()
        # final stats report (reference run_integrated_rag._show_final_stats)
        st = sys_.get_system_stats()
        print(
            f"final stats: docs={st['engine']['index']['count']} "
            f"queries={st['engine']['query_stats']['total_queries']} "
            f"avg_retrieval={st['engine']['query_stats']['avg_retrieval_time']*1000:.1f}ms "
            f"cache_hit_ratio={st['pipeline']['cache_hit_ratio']:.2f}",
            flush=True,
        )
        sys_.shutdown()


def run_gui(cfg: RAGConfig, device: str = "cuda") -> int:
    from modular_rag_system_tpu_torch.gui import launch_gui

    sys_ = _build_system(cfg, device)
    sys_.start()
    try:
        launch_gui(sys_)
        return 0
    except RuntimeError as exc:
        print(f"error: {exc}")
        return 1
    finally:
        sys_.shutdown()


def run_one_query(cfg: RAGConfig, query: str, show_stats: bool,
                  device: str = "cuda") -> int:
    sys_ = _build_system(cfg, device)
    try:
        resp = sys_.enhanced_query(query)
        print(resp["insight"])
        print(f"\nconfidence={resp['confidence']} type={resp['query_type']}")
        if resp["follow_up_queries"]:
            print("follow-ups:", "; ".join(resp["follow_up_queries"]))
        if show_stats:
            print(json.dumps(sys_.get_system_stats(), indent=2, default=str))
        return 0
    finally:
        sys_.shutdown()


# ---------------------------------------------------------------------------
def main(argv: Optional[list] = None) -> int:
    args = build_arg_parser().parse_args(argv)
    cfg = load_config(args)
    dev = args.device
    if args.test:
        return run_self_test(cfg, dev)
    if args.interactive:
        return run_interactive_menu(cfg, dev)
    if args.cli:
        return run_repl(cfg, dev)
    if args.gui:
        return run_gui(cfg, dev)
    if args.daemon:
        return run_daemon(cfg, dev)
    if args.query:
        return run_one_query(cfg, args.query, args.stats, dev)
    if args.init_only:
        sys_ = _build_system(cfg, dev)
        print(json.dumps(sys_.get_system_stats(), indent=2, default=str))
        sys_.shutdown()
        return 0
    build_arg_parser().print_help()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
