"""Tkinter GUI — parity with the reference ``RAGQueryInterface``

(``rag_query_interface.py:574-891``): three tabs (query with a
query-type selector + insight / retrieved-context / follow-up panes;
history; analytics), with query processing on a worker thread marshaled
back to the GUI via ``root.after``.

Gated: importing this module is safe everywhere; ``launch_gui`` raises a
clear error when tkinter or a display is unavailable (headless
containers), matching the reference's graceful-degradation pattern.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


def format_stats(stats: dict) -> str:
    """Render ``get_system_stats()`` as the reference's structured
    analytics summary (``rag_query_interface.py:822-859``) — sectioned
    human-readable text, not a raw JSON dump.  Pure function so headless
    tests can cover the analytics surface without a display."""
    eng = stats.get("engine", {}) or {}
    qs = eng.get("query_stats", {}) or {}
    store = eng.get("store", {}) or {}
    index = eng.get("index", {}) or {}
    pipe = stats.get("pipeline", {}) or {}
    proc = stats.get("processor", {}) or {}
    files = stats.get("files", {}) or {}
    keys = stats.get("keystrokes")
    mem_mb = index.get("memory_bytes", 0) / 1e6
    ivf = index.get("ivf") or {}
    ann_line = (
        f"  ann structure:      {ivf.get('clusters', 0)} clusters "
        f"({ivf.get('fine_dtype', '?')} fine, "
        f"{ivf.get('fine_bytes', 0) / 1e6:.1f} MB), "
        f"built {ivf.get('built', 0)} + tail {ivf.get('tail_rows', 0)}, "
        f"{ivf.get('rebuilds', 0)} rebuilds"
        if ivf else None
    )
    lines = [
        "RAG System Statistics",
        "",
        "Retrieval engine:",
        f"  total documents:    {store.get('total_documents', 0)}",
        f"  index tier:         {index.get('tier', '?')} "
        f"({index.get('count', 0)}/{index.get('capacity', 0)} rows, "
        f"dim {index.get('dim', '?')}, {mem_mb:.1f} MB device)",
        *([ann_line] if ann_line else []),
        f"  encoder:            {eng.get('encoder', '?')}",
        f"  total queries:      {qs.get('total_queries', 0)}",
        f"  avg retrieval time: {qs.get('avg_retrieval_time', 0.0):.4f}s",
        f"  documents added:    {qs.get('total_documents_added', 0)}",
        "",
        "Embedding pipeline:",
        f"  requests:        {pipe.get('total_requests', 0)} "
        f"({pipe.get('total_chunks', 0)} chunks)",
        f"  cache:           {pipe.get('cache_size', 0)} entries, "
        f"hit ratio {pipe.get('cache_hit_ratio', 0.0):.1%}",
        f"  avg batch time:  {pipe.get('avg_processing_time', 0.0):.4f}s",
        "",
        "Query processor:",
        f"  queries:    {proc.get('queries', 0)}",
        f"  cache:      {proc.get('cache_size', 0)} entries, "
        f"{proc.get('cache_hits', 0)} hits",
        f"  llm calls:  {proc.get('llm_calls', 0)} "
        f"({proc.get('fallbacks', 0)} fallbacks)",
        "",
        "Ingestion:",
        f"  uploaded files: {files.get('count', 0)}"
        + (f" (serving on :{files['port']})" if files.get("port") else ""),
    ]
    if keys:
        lines += [
            f"  keystrokes:     {keys.get('events_total', 0)} events, "
            f"{keys.get('sessions_total', 0)} sessions, "
            f"avg {keys.get('avg_wpm', 0.0)} WPM",
        ]
    by_source = store.get("by_source") or {}
    if by_source:
        lines += ["", "Documents by source:"]
        lines += [f"  {src}: {n}" for src, n in sorted(by_source.items())]
    if stats.get("llm"):
        lines += ["", f"LLM: {stats['llm']}"]
    lines += ["", f"System running: {'yes' if stats.get('started') else 'no'}"]
    return "\n".join(lines)


def tkinter_available() -> bool:
    try:
        import tkinter  # noqa: F401
    except Exception:
        return False
    import os

    return bool(os.environ.get("DISPLAY") or os.name == "nt")


class RAGQueryGUI:
    def __init__(self, system) -> None:
        """``system`` is an ``EnhancedRAGSystem`` facade."""
        import tkinter as tk
        from tkinter import ttk

        self.system = system
        self.root = tk.Tk()
        self.root.title("modular_rag_system_tpu_torch")
        self.root.geometry("900x640")
        nb = ttk.Notebook(self.root)
        nb.pack(fill="both", expand=True)

        # --- query tab -------------------------------------------------
        qf = ttk.Frame(nb)
        nb.add(qf, text="Query")
        top = ttk.Frame(qf)
        top.pack(fill="x", padx=8, pady=6)
        self.query_var = tk.StringVar()
        entry = ttk.Entry(top, textvariable=self.query_var)
        entry.pack(side="left", fill="x", expand=True)
        entry.bind("<Return>", lambda _e: self.submit_query())
        self.qtype_var = tk.StringVar(value="auto")
        for qt in ("auto", "question", "suggestion", "completion", "analysis"):
            ttk.Radiobutton(top, text=qt, value=qt, variable=self.qtype_var).pack(
                side="left", padx=2
            )
        ttk.Button(top, text="Ask", command=self.submit_query).pack(side="right")
        self.insight = tk.Text(qf, height=12, wrap="word")
        self.insight.pack(fill="both", expand=True, padx=8, pady=4)
        self.context = tk.Text(qf, height=8, wrap="word")
        self.context.pack(fill="both", expand=True, padx=8, pady=4)
        # follow-ups: double-click re-executes (reference
        # ``rag_query_interface.py:815-821`` execute_followup)
        self.followups = tk.Listbox(qf, height=3)
        self.followups.pack(fill="x", padx=8, pady=4)
        self.followups.bind("<Double-Button-1>", self._run_followup)

        # status bar (reference's processing-time/confidence line)
        self.status_var = tk.StringVar(value="ready")
        ttk.Label(self.root, textvariable=self.status_var, anchor="w").pack(
            fill="x", padx=8, pady=2
        )

        # --- history tab -----------------------------------------------
        hf = ttk.Frame(nb)
        nb.add(hf, text="History")
        self.history = ttk.Treeview(
            hf,
            columns=("time", "query", "type", "confidence", "sources"),
            show="headings",
        )
        for col, w in (("time", 120), ("query", 380), ("type", 100),
                       ("confidence", 90), ("sources", 70)):
            self.history.heading(col, text=col)
            self.history.column(col, width=w)
        self.history.pack(fill="both", expand=True, padx=8, pady=6)

        # --- analytics tab ----------------------------------------------
        af = ttk.Frame(nb)
        nb.add(af, text="Analytics")
        self.analytics = tk.Text(af, wrap="word", font=("Courier", 10))
        self.analytics.pack(fill="both", expand=True, padx=8, pady=6)
        ttk.Button(af, text="Refresh", command=self.refresh_analytics).pack(pady=4)
        self._schedule_analytics_refresh()

    # ------------------------------------------------------------------
    def submit_query(self) -> None:
        query = self.query_var.get().strip()
        if not query:
            return
        self.insight.delete("1.0", "end")
        self.insight.insert("1.0", "processing...")
        self.status_var.set("processing...")
        t0 = time.time()

        def worker():
            try:
                resp = self.system.enhanced_query(query)
            except Exception as exc:  # surfaced, never crashes the GUI
                resp = {"insight": f"error: {exc}", "confidence": 0.0,
                        "query_type": "?", "sources": [], "follow_up_queries": []}
            dt = time.time() - t0
            self.root.after(0, lambda: self._render(query, resp, dt))

        threading.Thread(target=worker, daemon=True).start()

    def _run_followup(self, _event) -> None:
        sel = self.followups.curselection()
        if sel:
            self.query_var.set(self.followups.get(sel[0]))
            self.submit_query()

    def _render(self, query: str, resp: dict, dt: float) -> None:
        self.insight.delete("1.0", "end")
        self.insight.insert("1.0", resp["insight"])
        self.context.delete("1.0", "end")
        sources = resp.get("sources", [])
        for s in sources:
            self.context.insert(
                "end", f"({s['similarity']:.2f}) [{s['source']}] {s['snippet']}\n"
            )
        self.followups.delete(0, "end")
        for fu in resp.get("follow_up_queries", []):
            self.followups.insert("end", fu)
        conf = resp.get("confidence", 0.0)
        self.status_var.set(
            f"query processed in {dt:.2f}s (confidence: {conf:.1%})"
        )
        self.history.insert(
            "",
            0,
            values=(
                time.strftime("%H:%M:%S"),
                query if len(query) <= 50 else query[:50] + "...",
                resp.get("query_type", "?"),
                f"{conf:.1%}",
                len(sources),
            ),
        )

    def refresh_analytics(self) -> None:
        try:
            text = format_stats(self.system.get_system_stats())
        except Exception as exc:
            text = f"stats unavailable: {exc}"
        self.analytics.delete("1.0", "end")
        self.analytics.insert("1.0", text)

    def _schedule_analytics_refresh(self) -> None:
        """Periodic refresh, like the reference's update_statistics loop."""
        self.refresh_analytics()
        self.root.after(10_000, self._schedule_analytics_refresh)

    def run(self) -> None:
        self.refresh_analytics()
        self.root.mainloop()


def launch_gui(system) -> None:
    if not tkinter_available():
        raise RuntimeError(
            "tkinter or a display is unavailable; use the CLI "
            "(python -m modular_rag_system_tpu_torch.launcher --cli) instead"
        )
    RAGQueryGUI(system).run()
