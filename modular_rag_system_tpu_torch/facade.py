"""EnhancedRAGSystem — the full-system facade.

The reference's ``enhanced_rag_system.py`` contained TWO pasted copies of
this class; Python kept the second, which silently dropped
``query_with_files`` / ``get_system_stats`` and broke
``examples/basic_usage.py:24,37`` and ``rag_launcher.py:160`` at runtime
(SURVEY §2.6).  This facade deliberately exposes BOTH API families:

* the file-reference family: ``start``, ``query_with_files``,
  ``add_file_from_path``, ``get_system_stats``,
* the enhancement family: ``enhanced_query``, ``add_context_switch``,
  ``record_feedback``, ``process_uploaded_file``.

It wires: RAGEngine (device index + encoder) + EmbeddingPipeline +
FileUploadManager + the three enhancement subsystems + optional capture
adapters + optional LLM client, all sharing ONE engine instance (the
reference accidentally built two parallel RAG systems,
``run_integrated_rag.py:325`` note in SURVEY §3.5).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from modular_rag_system_tpu_torch.config import RAGConfig
from modular_rag_system_tpu_torch.engine import RAGEngine
from modular_rag_system_tpu_torch.ingest.files import FileUploadManager
from modular_rag_system_tpu_torch.ingest.keystrokes import KeystrokeCapture
from modular_rag_system_tpu_torch.ingest.privacy import PrivacyFilter
from modular_rag_system_tpu_torch.llm import build_llm_client
from modular_rag_system_tpu_torch.orchestration.aggregator import ContextAggregator
from modular_rag_system_tpu_torch.orchestration.enhancements import (
    CrossAppContextBridge,
    LearningAdaptationSystem,
    PredictiveContextSwitcher,
)
from modular_rag_system_tpu_torch.orchestration.processor import RAGQueryProcessor
from modular_rag_system_tpu_torch.pipeline import EmbeddingPipeline


class EnhancedRAGSystem:
    def __init__(
        self,
        config: Optional[RAGConfig] = None,
        llm_client=None,
        capture_batch_size: int = 1,
        enable_llm: bool = True,
        device="cuda",
        index_devices=None,
    ) -> None:
        """``capture_batch_size > 1`` routes capture callbacks through a

        ``pipeline.MicroBatcher`` (reference ``KeystrokeEmbeddingProcessor``
        semantics: flush at batch_size or 30 s); the default is immediate
        per-callback ingest.  ``enable_llm=False`` skips LLM probing
        entirely (hermetic tests / air-gapped deployments).  ``device`` is
        the engine's (``"cuda"``, or ``"cpu"`` when asked for);
        ``index_devices`` the shards' of a sharded index."""
        self.config = config or RAGConfig()
        self.engine = RAGEngine(self.config, device=device, index_devices=index_devices)
        self.pipeline = EmbeddingPipeline(
            self.engine.encoder,
            self.engine.chunker,
            cache_size=self.config.embedding.cache_size,
        )
        self.privacy = PrivacyFilter(
            enabled=self.config.privacy.enabled,
            anonymize=self.config.privacy.anonymize,
            blocked_applications=self.config.privacy.blocked_applications,
            blocked_window_keywords=self.config.privacy.blocked_window_keywords,
        )
        self.files = FileUploadManager(
            upload_folder=str(
                Path(self.config.store.storage_path) / self.config.serving.upload_folder
            ),
            port=self.config.serving.file_server_port,
        )
        self.aggregator = ContextAggregator()
        self.bridge = CrossAppContextBridge()
        self.predictor = PredictiveContextSwitcher()
        self.learner = LearningAdaptationSystem()
        if not enable_llm:
            self.llm = None
        elif llm_client is not None:
            self.llm = llm_client or None  # falsy sentinel also disables
        else:
            self.llm = build_llm_client(self.config)
        self.processor = RAGQueryProcessor(
            self.engine,
            llm_client=self.llm,
            cache_ttl_s=self.config.serving.response_cache_ttl_s,
            cache_max=self.config.serving.response_cache_max,
        )
        self.keystrokes: Optional[KeystrokeCapture] = None
        self.ocr = None
        self._training_pairs: List = []
        self._trainer = None  # lazily built, cached ContrastiveTrainer
        self.batcher = None
        if capture_batch_size > 1:
            from modular_rag_system_tpu_torch.pipeline import MicroBatcher

            self.batcher = MicroBatcher(
                self.pipeline, self.engine, batch_size=capture_batch_size
            )
            self.batcher.start_background()
        self._started = False

    # ------------------------------------------------------------------
    # lifecycle
    def start(self, serve_files: bool = True, ingest_uploads: bool = True) -> None:
        """Reference ``EnhancedRAGSystem.start`` (``enhanced_rag_system.py:1149``)."""
        if serve_files:
            self.files.start_web_server()
        if ingest_uploads:
            for rec in self.files.upload_folder_contents(
                str(Path(self.config.store.storage_path) / "inbox")
            ):
                self.process_uploaded_file(rec.file_id)
        self._started = True

    def enable_keystroke_capture(self, attach_os_listener: bool = False) -> KeystrokeCapture:
        """Opt-in keystroke adapter wired into the ingest pipeline."""
        if self.keystrokes is None:
            self.keystrokes = KeystrokeCapture(
                privacy=self.privacy, rag_callback=self._capture_sink
            )
            self.keystrokes.start()
            if attach_os_listener:
                self.keystrokes.attach_listener()
        return self.keystrokes

    def enable_ocr(self, backend, analysis_interval_s: float = 10.0,
                   min_confidence: float = 0.7, start: bool = True):
        """Opt-in OCR ingest loop (reference ``run_integrated_rag.py:251-296``).

        ``backend`` is any callable returning {"text", "confidence",
        "window"} or None; results flow through the privacy filter into
        the same capture sink as keystrokes."""
        from modular_rag_system_tpu_torch.ingest.ocr import OCRIngestLoop

        self.ocr = OCRIngestLoop(
            backend,
            sink=self._capture_sink,
            privacy=self.privacy,
            analysis_interval_s=analysis_interval_s,
            min_confidence=min_confidence,
        )
        if start:
            self.ocr.start()
        return self.ocr

    def _capture_sink(self, content: str, metadata: Dict[str, Any]) -> None:
        ctype = metadata.get("content_type", "keystroke")
        self.aggregator.add_keystroke_context(content, metadata) if ctype == "keystroke" \
            else self.aggregator.add_ocr_context(content, metadata)
        self.bridge.add_context(metadata.get("application", "unknown"), content)
        if self.batcher is not None:
            self.batcher.add(content, metadata)
        else:
            results = self.pipeline.process_content(content, ctype, metadata)
            docs = self.pipeline.create_rag_documents(results, source=ctype)
            self.engine.add_documents(docs)

    def shutdown(self) -> None:
        if self.keystrokes is not None:
            self.keystrokes.stop()
        if self.ocr is not None:
            self.ocr.stop()
        if self.batcher is not None:
            self.batcher.stop()
        self.files.stop_web_server()
        self.engine.shutdown()
        self._started = False

    # ------------------------------------------------------------------
    # file family
    def add_file_from_path(self, path: str, ingest: bool = True):
        rec = self.files.add_file(path)
        if rec and ingest:
            self.process_uploaded_file(rec.file_id)
        return rec

    def process_uploaded_file(self, file_id: str) -> int:
        """read -> chunk/embed -> batch add; returns number of chunks."""
        rec = self.files.get_file(file_id)
        if rec is None:
            return 0
        text = self.files.read_text(rec)
        results = self.pipeline.process_content(
            text, "document", {"file_id": file_id, "filename": rec.original_name}
        )
        docs = self.pipeline.create_rag_documents(results, source=rec.original_name)
        for d in docs:
            d.metadata["file_id"] = file_id
            d.metadata["access_link"] = rec.access_link
        self.engine.add_documents(docs)
        return len(docs)

    def query_with_files(self, query: str, max_results: int = 5) -> Dict[str, Any]:
        """RAG results + relevant file links (the API family the reference

        lost to its duplicate class definition)."""
        res = self.engine.query(query, max_results=max_results)
        file_refs = [f.to_dict() for f in self.files.find_relevant_files(query)]
        return {
            "query": query,
            "results": [
                {
                    "content": d.content,
                    "source": d.source,
                    "similarity": s,
                    "access_link": d.metadata.get("access_link"),
                }
                for d, s in zip(res.documents, res.similarities)
            ],
            "file_references": file_refs,
            "retrieval_time": res.retrieval_time,
            "total_documents_searched": res.total_documents_searched,
        }

    # ------------------------------------------------------------------
    # enhancement family
    def enhanced_query(
        self,
        query: str,
        current_app: str = "",
        current_content: str = "",
    ) -> Dict[str, Any]:
        """Reference ``enhanced_query`` (``enhanced_rag_system.py:1205``)."""
        if current_app and current_content:
            self.bridge.add_context(current_app, current_content)
        ctx = self.aggregator.build_query_context(query)
        if current_app:
            ctx.active_application = current_app
        resp = self.processor.process_query(query, ctx)
        adjustments = self.learner.get_response_adjustments(query)
        confidence = round(
            min(resp.confidence * adjustments["confidence_modifier"], 1.0), 3
        )
        return {
            "query": query,
            "insight": resp.insight,
            "confidence": confidence,
            "query_type": resp.query_type,
            "sources": resp.sources,
            "follow_up_queries": resp.follow_up_queries,
            "bridged_contexts": self.bridge.get_bridged_context(query),
            "predicted_contexts": (
                self.predictor.predict_next_context(current_app) if current_app else []
            ),
            "learning_adjustments": adjustments,
            "file_references": [f.to_dict() for f in self.files.find_relevant_files(query)],
            "from_cache": resp.from_cache,
            "processing_time": resp.processing_time,
        }

    def add_context_switch(self, from_app: str, to_app: str) -> None:
        self.predictor.record_context_switch(from_app, to_app)

    def record_feedback(
        self, query: str, feedback_type: str, matched_content: Optional[str] = None
    ) -> None:
        """Record feedback; positive/followed feedback with the matched

        document content also becomes a (query, positive) training pair
        for ``fine_tune_from_feedback``."""
        self.learner.record_feedback(query, feedback_type)
        if matched_content and feedback_type in ("positive", "followed"):
            self._training_pairs.append((query, matched_content))

    # ------------------------------------------------------------------
    # closing the loop: feedback -> fine-tune -> refresh the index
    def fine_tune_from_feedback(
        self,
        steps: int = 20,
        learning_rate: float = 1e-5,
        min_pairs: int = 4,
        extra_pairs: Optional[List] = None,
    ) -> Optional[Dict[str, Any]]:
        """Fine-tune the serving encoder on accumulated positive-feedback

        (query, document) pairs, publish the weights, and re-embed the
        whole corpus so stored vectors stay in the new embedding space.
        A capability with no reference analog: its embedders were frozen.
        Returns training metrics, or None when too few pairs exist or the
        encoder isn't trainable (fake/ollama backends, ModernBERT)."""
        from modular_rag_system_tpu_torch.models.encoder import MiniLMEncoder
        from modular_rag_system_tpu_torch.models.lexical import HybridEncoder

        pairs = list(self._training_pairs) + list(extra_pairs or [])
        # hybrid default (round 5): fine-tune the DENSE side; the
        # lexical half is statistics, not weights.  The hybrid wrapper
        # shares the dense object, so synced params flow straight into
        # serving (and reembed_all below refreshes stored vectors).
        enc = self.engine.encoder
        if isinstance(enc, HybridEncoder):
            enc = enc.dense
        if (len(pairs) < min_pairs or not isinstance(enc, MiniLMEncoder)
                or enc.model_type != "bert"):
            return None
        from modular_rag_system_tpu_torch.models.train import ContrastiveTrainer
        from modular_rag_system_tpu_torch.parallel import multihost
        from modular_rag_system_tpu_torch.parallel.mesh import make_train_mesh

        # one trainer per facade keeps the optimizer moments warm across
        # feedback rounds; a new learning rate builds a new one, which
        # starts from the encoder's published weights.  With a live
        # process group of W ranks (every rank calls this), the JAX
        # facade's rule with ranks for devices: a (W / mp, mp) layout,
        # mp = 2 when W is even
        trainer = self._trainer
        if trainer is None or trainer.learning_rate != learning_rate:
            mesh = None
            if multihost.is_initialized():
                n = multihost.world_size()
                model_par = 2 if n % 2 == 0 and n > 1 else 1
                mesh = make_train_mesh(n // model_par, model_par)
            trainer = ContrastiveTrainer(enc, mesh, learning_rate=learning_rate)
            self._trainer = trainer
        qs = [q for q, _ in pairs]
        ps = [p for _, p in pairs]
        loss = acc = 0.0
        for _ in range(steps):
            loss, acc = trainer.step(qs, ps)
        trainer.sync_encoder()
        rebuilt = self.engine.reembed_all()
        self._training_pairs.clear()
        return {
            "pairs": len(pairs),
            "steps": steps,
            "final_loss": float(loss),
            "final_in_batch_acc": float(acc),
            "rows_reembedded": rebuilt,
        }

    # ------------------------------------------------------------------
    def get_system_stats(self) -> Dict[str, Any]:
        return {
            "engine": self.engine.get_system_stats(),
            "pipeline": self.pipeline.get_stats(),
            "processor": self.processor.get_stats(),
            "files": {"count": len(self.files.files), "port": self.files.port},
            "keystrokes": (
                self.keystrokes.get_statistics() if self.keystrokes else None
            ),
            "llm": getattr(self.llm, "model", None) if self.llm else None,
            "started": self._started,
            "timestamp": time.time(),
        }
