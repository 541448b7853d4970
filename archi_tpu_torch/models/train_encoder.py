"""Contrastive training of the PyTorch BERT encoder from a corpus alone.

Counterpart of ``archi_tpu/models/train_encoder.py``.  Zero egress means no
pretrained sentence-transformers weights, so a deployment trains a small
WordPiece + BERT bi-encoder on the card from its own corpus:

- vocab: ``WordPieceTokenizer.build_vocab`` over the corpus;
- pairs: inverse-cloze-style views of each chunk (a sampled keyword
  "query" view vs the full chunk), corpus-mined paraphrases (acronyms,
  definitions, aliases, salient terms) and optional caller-supplied pairs;
- loss: symmetric in-batch InfoNCE over L2-normalised pooled embeddings,
  temperature-scaled;
- optimizer: ``torch.optim.AdamW`` with the cosine decay of
  ``optax.cosine_decay_schedule(lr, steps, alpha=0.05)``; f32 parameters,
  the forward pass in bf16 (attention on the ``encoder_attention`` kernel,
  its gradient through the plain version).

The pair mining, vocabulary and batch sampling are the JAX package's code,
copied verbatim, so one seed gives the same pairs and the same batches in
both packages; the initial parameters are ``bert.init_params``'s, the same
draws as the JAX package's.  ``train_step`` is one optimizer step over a
padded batch, in whatever compute dtype the model holds (the tests run it
at f32 against ``jax.value_and_grad``).

The result saves as the same HF snapshot directory (``config.json`` +
``model.safetensors`` in ``BertModel`` naming + ``vocab.txt``), byte-identical
to the JAX package's export, which ``TorchEmbedder(model_dir=...)`` and
``JaxEmbedder(model_dir=...)`` both load::

    config, model, tokenizer = train(texts, device="cuda")
    save_model_dir("model", config, model, tokenizer)
"""

from __future__ import annotations

import json
import math
import os
import re

import numpy as np
import torch
import torch.nn.functional as F

from archi_tpu_torch.models.bert import (BertConfig, BertEncoder, embed,
                                         init_params)
from archi_tpu_torch.models.hf_loader import params_from_jax
from archi_tpu_torch.models.tokenizer import WordPieceTokenizer
from archi_tpu_torch.utils.hardware import default_device


def small_config(vocab_size: int, pooling: str = "mean",
                 hidden: int = 256, layers: int = 4) -> BertConfig:
    """Default 4-layer, 256-wide encoder; ``hidden``/``layers`` scale it
    up (6 x 384 is MiniLM-L6's width)."""
    return BertConfig(vocab_size=vocab_size, hidden_size=hidden,
                      num_layers=layers, num_heads=max(4, hidden // 64),
                      intermediate_size=4 * hidden,
                      max_position_embeddings=256, pooling=pooling)


_WORD_RE = re.compile(r"[a-z0-9]+")

# acronym ↔ expansion: "long form (ACRO)" or "ACRO (long form)" —
# Schwartz-Hearst-style, initials must match the expansion's word heads
_ACRO_RE = re.compile(
    r"\b((?:[A-Za-z][a-z0-9]+[ -]){1,5}[A-Za-z][a-z0-9]+)\s*"
    r"\(\s*([A-Z][A-Za-z0-9]{1,9})\s*\)"
)
_ACRO_REV_RE = re.compile(
    r"\b([A-Z][A-Za-z0-9]{1,9})\s*\(\s*((?:[A-Za-z][a-z0-9]+[ -]){1,5}"
    r"[A-Za-z][a-z0-9]+)\s*\)"
)
# definition / alias sentences: "X is a/the ...", "X, also known as Y"
_DEF_RE = re.compile(
    r"\b([A-Za-z][\w-]*(?: [A-Za-z][\w-]*){0,3}) is (?:a|an|the) "
    r"([a-z][\w-]*(?: [a-z][\w-]*){1,6})")
_AKA_RE = re.compile(
    r"\b([A-Za-z][\w-]*(?: [A-Za-z][\w-]*){0,3}),? (?:also known as|aka|"
    r"a\.k\.a\.) ([A-Za-z][\w-]*(?: [A-Za-z][\w-]*){0,3})")


def _trim_expansion(expansion: str, acro: str) -> str | None:
    """Longest suffix of ``expansion`` whose word initials spell ``acro``
    (the regex match is leftmost-greedy and can swallow leading words:
    'The Compact Muon Solenoid (CMS)' → drop 'The')."""
    words = [w for w in re.split(r"[ -]", expansion) if w]
    for start in range(len(words)):
        cand = words[start:]
        if "".join(w[0].lower() for w in cand) == acro.lower():
            return " ".join(cand)
    return None


def mine_pairs(texts: list[str], *, salient_views: int = 2,
               mid_views: int = 2,
               exclude_terms: set[str] | None = None
               ) -> list[tuple[str, str]]:
    """Paraphrase supervision mined from the CORPUS ALONE (VERDICT r3
    item 3): no query templates, no eval leakage.

    - **acronym ↔ expansion** (``long form (ACRO)`` / ``ACRO (long
      form)``, initials checked): the acronym alone, the expansion
      alone, and each-as-query-for-the-other's chunk;
    - **definition / alias sentences** (``X is a <category> ...``,
      ``X also known as Y``): the defined term and its category/alias
      phrase both retrieve the defining chunk;
    - **salient-term views**: document-frequency-weighted keyword
      queries — the chunk's LOWEST-DF (most identifying) terms, which
      teaches the encoder an IDF prior that plain uniform ICT sampling
      does not (generic words stop hijacking the mean pooling).

    ``exclude_terms``: lowercased words that must never appear in a mined
    QUERY view (the held-out-alias eval protocol,
    ``benchmarking/fixture.py fixture_alias_split``): any pair whose
    query side contains one is dropped, so the alias↔term mapping is
    never supervised — it can only be absorbed distributionally from the
    defining document's text.
    """
    excl = {w.lower() for w in (exclude_terms or ())}

    def _blocked(q: str) -> bool:
        return bool(excl) and any(w in excl for w in _WORD_RE.findall(
            q.lower()))

    pairs_raw: list[tuple[str, str]] = []
    pairs = pairs_raw
    # --- document frequency over word types
    df: dict[str, int] = {}
    tokenized = []
    for t in texts:
        words = _WORD_RE.findall(t.lower())
        tokenized.append(words)
        for w in set(words):
            df[w] = df.get(w, 0) + 1

    for t in texts:
        for exp, acro in _ACRO_RE.findall(t):
            exp = _trim_expansion(exp, acro)
            if exp:
                pairs += [(acro, t), (exp, t), (acro, exp), (exp, acro)]
        for acro, exp in _ACRO_REV_RE.findall(t):
            exp = _trim_expansion(exp, acro)
            if exp:
                pairs += [(acro, t), (exp, t), (acro, exp), (exp, acro)]
        for term, definition in _DEF_RE.findall(t):
            if df.get(term.lower().split()[0], 0) <= len(texts) // 4:
                pairs += [(term, t), (f"{term} {definition}", t)]
        for term, alias in _AKA_RE.findall(t):
            pairs += [(alias, t), (term, t), (alias, term)]

    # --- salient-term views: lowest-DF terms identify the chunk
    rng = np.random.default_rng(11)
    n_docs = len(texts)
    for words, t in zip(tokenized, texts):
        uniq = sorted(set(words), key=lambda w: (df.get(w, 0), w))
        salient = [w for w in uniq if df.get(w, 0) < max(2, n_docs // 8)][:12]
        if len(salient) < 2:
            continue
        for _ in range(salient_views):
            k = int(rng.integers(2, min(5, len(salient) + 1)))
            sel = rng.choice(len(salient), size=k, replace=False)
            pairs.append((" ".join(salient[i] for i in sorted(sel)), t))
        # mid-DF term-PAIR views: terms that are not individually
        # distinctive (shared with sibling chunks) but jointly identify
        # this one — real queries name 2-3 topic words without the
        # chunk's rarest identifiers, and resolving the COMBINATION is
        # a different skill than resolving a rare term
        mid = [w for w in uniq
               if max(2, n_docs // 8) <= df.get(w, 0) < max(3, n_docs // 2)]
        if len(mid) >= 2:
            for _ in range(mid_views):
                sel = rng.choice(len(mid), size=2, replace=False)
                pairs.append(
                    (" ".join(mid[i] for i in sorted(sel)), t))
    if excl:
        return [(q, d) for q, d in pairs_raw if not _blocked(q)]
    return pairs_raw


def _splice(q: str, noise: list[str], rng: np.random.Generator,
            lo: int = 1, hi: int = 5) -> str:
    """Insert ``lo..hi-1`` noise tokens into a query string at random word
    positions — the query-shape augmentation for SHORT mined views (real
    keyword queries wrap 2-3 signal terms in generic/unseen words the
    corpus never defines; without seeing that shape in training, mean
    pooling lets the wrapper words dominate exactly when the signal is
    shortest)."""
    qw = q.split()
    for _ in range(int(rng.integers(lo, hi))):
        qw.insert(int(rng.integers(0, len(qw) + 1)),
                  noise[int(rng.integers(0, len(noise)))])
    return " ".join(qw)


def noise_vocab(texts: list[str], *, top_frac: float = 0.02,
                n_pseudo: int = 64,
                seed: int = 13) -> list[str]:
    """Noise tokens for query augmentation: the corpus's HIGHEST-DF words
    (its own 'generic' register) plus random pseudo-words (stand-ins for
    query-side words the corpus has never seen — their subword embeddings
    must learn to not hijack the mean pooling)."""
    df: dict[str, int] = {}
    for t in texts:
        for w in set(_WORD_RE.findall(t.lower())):
            df[w] = df.get(w, 0) + 1
    common = sorted(df, key=df.get, reverse=True)
    common = common[: max(8, int(len(common) * top_frac))]
    rng = np.random.default_rng(seed)
    letters = "abcdefghijklmnopqrstuvwxyz"
    pseudo = ["".join(rng.choice(list(letters),
                                 size=int(rng.integers(4, 9))))
              for _ in range(n_pseudo)]
    return common + pseudo


def make_pairs(texts: list[str], rng: np.random.Generator,
               n_views: int = 4,
               noise: list[str] | None = None,
               splice_prob: float = 0.4) -> list[tuple[str, str]]:
    """Self-supervised (query, positive) pairs from raw chunks.

    Views per chunk: keyword subsamples (drop ~60% of words, keep order)
    and contiguous spans — both answerable only by mapping query terms to
    the chunk's vocabulary, which is exactly the retrieval skill.

    ``noise``: optional token pool (``noise_vocab``) — ~40% of query
    views get 1-3 noise tokens spliced in, so the encoder learns that
    off-topic/generic/unseen query words must not drag the embedding
    (real queries say "problem with X" where "problem" appears nowhere
    in the corpus; without this augmentation such words hijack the mean
    pooling — measured hard-query semantic-only 0.0 in QUALITY_r03).
    """
    pairs = []
    for t in texts:
        words = _WORD_RE.findall(t.lower())
        if len(words) < 6:
            continue
        for _ in range(n_views):
            if rng.random() < 0.5:
                keep = rng.random(len(words)) < 0.4
                if keep.sum() < 3:
                    keep[rng.choice(len(words), 3, replace=False)] = True
                qw = [w for w, k in zip(words, keep) if k]
            else:
                span = rng.integers(3, max(4, len(words) // 2))
                start = rng.integers(0, max(1, len(words) - span))
                qw = words[start:start + span]
            if noise and rng.random() < splice_prob:
                for _j in range(int(rng.integers(1, 4))):
                    qw.insert(int(rng.integers(0, len(qw) + 1)),
                              noise[int(rng.integers(0, len(noise)))])
            pairs.append((" ".join(qw), t))
    rng.shuffle(pairs)
    return pairs


def _pad(ids_list: list[list[int]], seq: int) -> tuple[np.ndarray, np.ndarray]:
    ids = np.zeros((len(ids_list), seq), np.int32)
    mask = np.zeros((len(ids_list), seq), np.int32)
    for r, lst in enumerate(ids_list):
        lst = lst[:seq]
        ids[r, : len(lst)] = lst
        mask[r, : len(lst)] = 1
    return ids, mask


# ------------------------------------------------------------- training
def cosine_lr(lr: float, steps: int, step: int, alpha: float = 0.05) -> float:
    """``optax.cosine_decay_schedule(lr, steps, alpha)`` at ``step``."""
    t = min(step, steps)
    return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / steps))
                 + alpha)


def make_optimizer(model: BertEncoder, lr: float) -> torch.optim.AdamW:
    """optax's ``adamw(lr, weight_decay=0.01)``: every parameter decays
    (optax masks none), b1 0.9, b2 0.999, eps 1e-8."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=0.01)


def contrastive_loss(model: BertEncoder, q_ids, q_mask, d_ids, d_mask, *,
                     tau: float) -> torch.Tensor:
    """Symmetric in-batch InfoNCE: row i of the queries against row i of
    the documents, every other row a negative."""
    zq = embed(model, q_ids, q_mask)
    zd = embed(model, d_ids, d_mask)
    logits = zq @ zd.T / tau                              # [B, B]
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels)
                  + F.cross_entropy(logits.T, labels))


def train_step(model: BertEncoder, optimizer: torch.optim.Optimizer, batch,
               *, tau: float, lr: float) -> torch.Tensor:
    """One AdamW step at learning rate ``lr`` over a padded batch
    ``(q_ids, q_mask, d_ids, d_mask)`` on the model's device; the forward
    pass runs in ``model.compute_dtype``.  Returns the loss before the
    step (a device scalar; reading it synchronises)."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.zero_grad(set_to_none=True)
    loss = contrastive_loss(model, *batch, tau=tau)
    loss.backward()
    optimizer.step()
    return loss.detach()


def to_batch(q_ids, q_mask, d_ids, d_mask, device) -> tuple:
    """``_pad`` outputs (numpy int32) → long tensors on ``device``."""
    return tuple(torch.from_numpy(a).to(device=device, dtype=torch.long)
                 for a in (q_ids, q_mask, d_ids, d_mask))


def batches(texts: list[str], tokenizer: WordPieceTokenizer,
            rng: np.random.Generator, *, steps: int, batch: int = 64,
            seq_len: int = 96, queries: list[tuple[str, str]] | None = None,
            mine: bool = True, noise_augment: bool = True,
            splice_prob: float = 0.4, hard_neg_frac: float = 0.0,
            splice_mined: float = 0.0, mid_views: int = 2,
            exclude_query_terms: set[str] | None = None, n_views: int = 4):
    """Each step's padded batch ``(q_ids, q_mask, d_ids, d_mask)`` (numpy
    int32 ``[b, seq_len]``), drawn from ``rng`` as the JAX package's
    ``train`` draws them (this is its code): the pair pool (ICT views,
    mined pairs, ``queries``), then per step at most one pair per positive
    chunk, a uniform draw or (``hard_neg_frac`` of the steps) a tf-idf
    neighbourhood of a seed chunk."""
    noise = noise_vocab(texts) if noise_augment else None
    pairs = make_pairs(texts, rng, n_views=n_views,
                       splice_prob=splice_prob, noise=noise)
    if mine:
        mined = mine_pairs(texts, mid_views=mid_views,
                           exclude_terms=exclude_query_terms)
        if noise and splice_mined > 0.0:
            # mined views are SHORT (an acronym, a 2-term combination) —
            # precisely where wrapper-word hijack bites; splice them too
            mined = [(_splice(q, noise, rng)
                      if rng.random() < splice_mined else q, d)
                     for q, d in mined]
        pairs.extend(mined)
    if queries:
        pairs.extend(queries)
    if exclude_query_terms:
        # strict query-side holdout: the held-out alias words never
        # appear on the QUERY side of any training pair (mined or ICT
        # view) — they reach the model only as document text, the same
        # distributional-only exposure a pretrained checkpoint gets
        excl = {w.lower() for w in exclude_query_terms}
        pairs = [(q, d) for q, d in pairs
                 if not any(w in excl for w in _WORD_RE.findall(q.lower()))]
    rng.shuffle(pairs)
    if not pairs:
        raise ValueError("no trainable pairs from corpus")
    q_tok = [tokenizer.encode(q, max_length=seq_len) for q, _ in pairs]
    d_tok = [tokenizer.encode(d, max_length=seq_len) for _, d in pairs]

    # --- group pair indices by positive chunk (one per batch) ---------
    pos_ids: dict[str, int] = {}
    by_pos: list[list[int]] = []
    for i, (_q, d) in enumerate(pairs):
        pid = pos_ids.setdefault(d, len(pos_ids))
        if pid == len(by_pos):
            by_pos.append([])
        by_pos[pid].append(i)
    n_pos = len(by_pos)

    neighbors = None
    if hard_neg_frac > 0.0 and n_pos > batch:
        # tf-idf cosine neighborhoods over the positive chunks
        uniq = [None] * n_pos
        for d, pid in pos_ids.items():
            uniq[pid] = d
        vocab: dict[str, int] = {}
        rows, cols, vals = [], [], []
        dfc: dict[str, int] = {}
        toks = [set(_WORD_RE.findall(d.lower())) for d in uniq]
        for ws in toks:
            for w in ws:
                dfc[w] = dfc.get(w, 0) + 1
        for r, ws in enumerate(toks):
            for w in ws:
                if dfc[w] >= n_pos // 2:      # drop corpus-generic terms
                    continue
                c = vocab.setdefault(w, len(vocab))
                rows.append(r)
                cols.append(c)
                vals.append(np.log(n_pos / dfc[w]))
        m = np.zeros((n_pos, len(vocab)), np.float32)
        m[rows, cols] = vals
        m /= np.maximum(np.linalg.norm(m, axis=1, keepdims=True), 1e-9)
        sim = m @ m.T
        np.fill_diagonal(sim, -1.0)
        neighbors = np.argsort(-sim, axis=1)[:, : batch * 2]

    for _ in range(steps):
        b = min(batch, n_pos)
        if neighbors is not None and rng.random() < hard_neg_frac:
            seed_pid = int(rng.integers(0, n_pos))
            # the pool spans ALL columns when n_pos <= 2*batch, so the
            # seed itself (diag sim = -1, sorted last) can be inside it —
            # drop it or the batch holds the seed's positive twice (the
            # duplicate-positive false negative this sampler exists to
            # prevent)
            pool = neighbors[seed_pid]
            pool = pool[pool != seed_pid]
            sel_pos = np.concatenate([[seed_pid],
                                      rng.permutation(pool)[: b - 1]])
        else:
            sel_pos = rng.choice(n_pos, size=b, replace=False)
        idx = [by_pos[p][int(rng.integers(0, len(by_pos[p])))]
               for p in sel_pos]
        yield (*_pad([q_tok[i] for i in idx], seq_len),
               *_pad([d_tok[i] for i in idx], seq_len))


def train(texts: list[str], *, queries: list[tuple[str, str]] | None = None,
          vocab_size: int = 8192, steps: int = 600, batch: int = 64,
          lr: float = 3e-4, tau: float = 0.05, seq_len: int = 96,
          seed: int = 0, config: BertConfig | None = None,
          mine: bool = True, noise_augment: bool = True,
          splice_prob: float = 0.4, hard_neg_frac: float = 0.0,
          splice_mined: float = 0.0, mid_views: int = 2,
          pooling: str = "mean",
          exclude_query_terms: set[str] | None = None,
          n_views: int = 4, hidden: int = 256, layers: int = 4,
          log_every: int = 100, log=print, device=None,
          losses: list | None = None):
    """→ (config, model, tokenizer); the model is a ``BertEncoder`` with f32
    parameters on ``device`` (the card by default, raising without it).
    The arguments are the JAX package's ``train``'s (see there and
    ``batches``), plus ``device`` and ``losses``: a list that receives
    every step's loss.  The forward pass runs in bf16, as the JAX
    trainer's does."""
    device = default_device(device)
    rng = np.random.default_rng(seed)
    tokenizer = WordPieceTokenizer.build_vocab(texts, size=vocab_size)
    config = config or small_config(tokenizer.vocab_size, pooling=pooling,
                                    hidden=hidden, layers=layers)
    model = BertEncoder.for_training(
        config, params_from_jax(init_params(config, seed=seed)),
        device=device, compute_dtype=torch.bfloat16)
    optimizer = make_optimizer(model, lr)
    step_losses = []
    padded = batches(
        texts, tokenizer, rng, steps=steps, batch=batch, seq_len=seq_len,
        queries=queries, mine=mine, noise_augment=noise_augment,
        splice_prob=splice_prob, hard_neg_frac=hard_neg_frac,
        splice_mined=splice_mined, mid_views=mid_views,
        exclude_query_terms=exclude_query_terms, n_views=n_views)
    for s, arrays in enumerate(padded):
        loss = train_step(model, optimizer, to_batch(*arrays, device=device),
                          tau=tau, lr=cosine_lr(lr, steps, s))
        step_losses.append(loss)
        if log_every and (s % log_every == 0 or s == steps - 1):
            log(f"step {s}: loss {float(loss):.4f}")
    if losses is not None:
        losses.extend(torch.stack(step_losses).float().cpu().tolist())
    return config, model, tokenizer


# ------------------------------------------------------------- HF export
def state_dict_from_params(params, config: BertConfig) -> dict:
    """A ``BertEncoder`` (or its state dict) → HF ``BertModel`` state-dict
    naming, numpy f32: the exact inverse of
    ``hf_loader.params_from_state_dict`` (the fused q/k/v weight splits
    back into query, key and value)."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    st = {k: v.detach().float().cpu().numpy() for k, v in params.items()}
    h = config.hidden_size
    sd = {
        "embeddings.word_embeddings.weight": st["word.weight"],
        "embeddings.position_embeddings.weight": st["position.weight"],
        "embeddings.token_type_embeddings.weight": st["token_type.weight"],
        "embeddings.LayerNorm.weight": st["emb_ln.weight"],
        "embeddings.LayerNorm.bias": st["emb_ln.bias"],
    }
    for i in range(config.num_layers):
        p, hf = f"layers.{i}.", f"encoder.layer.{i}."
        for j, name in enumerate(("query", "key", "value")):
            sd[f"{hf}attention.self.{name}.weight"] = \
                st[p + "qkv.weight"][j * h:(j + 1) * h]
            sd[f"{hf}attention.self.{name}.bias"] = \
                st[p + "qkv.bias"][j * h:(j + 1) * h]
        for short, name in (("o", "attention.output.dense"),
                            ("attn_ln", "attention.output.LayerNorm"),
                            ("ffn_i", "intermediate.dense"),
                            ("ffn_o", "output.dense"),
                            ("ffn_ln", "output.LayerNorm")):
            sd[f"{hf}{name}.weight"] = st[f"{p}{short}.weight"]
            sd[f"{hf}{name}.bias"] = st[f"{p}{short}.bias"]
    if "pool_attn" in st:
        # extra tensor beyond BertModel's schema; HF consumers ignore it,
        # both packages' loaders read it back when config.json says
        # archi_pooling == "attn"
        sd["pooler_attn.weight"] = st["pool_attn"]
    return {k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()}


def save_model_dir(model_dir: str, config: BertConfig, params,
                   tokenizer: WordPieceTokenizer) -> None:
    """Write an HF-loadable snapshot (config.json + model.safetensors +
    vocab.txt) of a ``BertEncoder`` or its state dict."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({
            "architectures": ["BertModel"],
            "model_type": "bert",
            **({"archi_pooling": config.pooling}
               if config.pooling != "mean" else {}),
            "vocab_size": config.vocab_size,
            "hidden_size": config.hidden_size,
            "num_hidden_layers": config.num_layers,
            "num_attention_heads": config.num_heads,
            "intermediate_size": config.intermediate_size,
            "max_position_embeddings": config.max_position_embeddings,
            "type_vocab_size": config.type_vocab_size,
            "layer_norm_eps": config.layer_norm_eps,
        }, f, indent=2)
    from safetensors.numpy import save_file

    save_file(state_dict_from_params(params, config),
              os.path.join(model_dir, "model.safetensors"))
    tokenizer.save_vocab(os.path.join(model_dir, "vocab.txt"))
