"""repro_torch.serve — assessment as a service.

A multi-tenant HTTP daemon over the incremental segment store: register
datasets (one ``repro_torch.store`` directory each), upload N-Triples or point
at server-side files to monitor, and the service queues incremental
assessments, serves DQV reports + quality-history trends, fires
threshold/regression alerts, and exposes Prometheus metrics.  Stdlib
HTTP only — no new dependencies.

Crash-safe: accepted jobs are journaled write-ahead (``jobs.jsonl``) and
replayed on restart, transient failures retry with backoff, hung jobs are
expired by a watchdog, repeatedly-failing datasets are quarantined by a
per-dataset circuit breaker (HTTP 503 + Retry-After), and
``DELETE /datasets/<name>`` reclaims a tenant's store.
``ServiceFaultInjector`` deterministically injects crashes / slow jobs /
transient errors / failing webhooks for testing all of the above.

Quickstart::

    from repro_torch.serve import QAServer, ServerConfig
    srv = QAServer(ServerConfig(store_root="qroot/"), port=8080).start()
    # curl -X PUT --data-binary @data.nt localhost:8080/datasets/my/data
    # curl localhost:8080/datasets/my/report

or from the CLI::

    python -m repro_torch.launch.qa_serve --port 8080 --store-root qroot/
"""
from .alerts import AlertRule, parse_rule, parse_rules, post_webhook
from .daemon import ApiError, QAServer, ServerConfig
from .faults import ServiceFaultInjector
from .jobs import (DatasetQuarantined, Job, JobQueue, JobTimeout,
                   QueueFull, TransientJobError)
from .journal import JobJournal
from .obs import Metrics
from .registry import (Dataset, DatasetRegistry, RegistryError,
                       UnknownDataset, validate_name)

__all__ = [
    "AlertRule", "parse_rule", "parse_rules", "post_webhook",
    "ApiError", "QAServer", "ServerConfig", "ServiceFaultInjector",
    "Job", "JobQueue", "QueueFull", "Metrics",
    "DatasetQuarantined", "JobTimeout", "TransientJobError", "JobJournal",
    "Dataset", "DatasetRegistry", "RegistryError", "UnknownDataset",
    "validate_name",
]
