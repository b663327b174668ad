"""Word-vector serialization (reference:
``models/embeddings/loader/WordVectorSerializer.java``, 2,603 LoC —
txt, Google word2vec binary, and zip formats).

Formats:
- txt: first line "V D", then one "word v1 v2 ..." per line
  (Google text format; reference ``writeWordVectors``/``loadTxt``).
- binary: header "V D\\n", then per word: name + 0x20 + D float32 LE
  (Google ``word2vec`` C binary; reference ``loadGoogleModel``).
- full model: zip of config.json + vocab.json + tables.npz preserving
  ALL training state — syn0 AND syn1/syn1neg + Huffman coding + word
  counts — so ``fit()`` resumes from disk (reference
  ``writeFullModel``/``loadFullModel``; the txt/binary interop formats
  keep only syn0 and cannot resume).

Counterpart of ``deeplearning4j_tpu/nlp/serializer.py``: the same
files, so word vectors and full models written by either package load
in the other. The tables cross to the host for writing and back to
the model's device on loading.
"""

from __future__ import annotations

import json
import zipfile
from typing import Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord


def _np(a):
    """A table (tensor on any device, or array) as a host array."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _resolve(model) -> Tuple[VocabCache, np.ndarray]:
    """Accept a SequenceVectors/Word2Vec/Glove or (cache, matrix)."""
    if isinstance(model, tuple):
        return model
    cache = model.cache
    if hasattr(model, "lookup"):
        matrix = _np(model.lookup.syn0)
    else:
        matrix = _np(model.syn0)
    return cache, _np(matrix)


def write_txt(model, path) -> None:
    cache, m = _resolve(model)
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"{m.shape[0]} {m.shape[1]}\n")
        for i in range(m.shape[0]):
            vals = " ".join(repr(float(x)) for x in m[i])
            f.write(f"{cache.word_at(i)} {vals}\n")


def _parse_txt(f) -> Tuple[VocabCache, np.ndarray]:
    header = f.readline().split()
    v, d = int(header[0]), int(header[1])
    cache = VocabCache()
    m = np.zeros((v, d), np.float32)
    for i in range(v):
        # rsplit from the right: the word itself may contain
        # spaces (n-gram vocab entries)
        parts = f.readline().rstrip("\n").rsplit(" ", d)
        cache.add(VocabWord(parts[0]))
        m[i] = [float(x) for x in parts[1:d + 1]]
    return cache, m


def load_txt(path) -> Tuple[VocabCache, np.ndarray]:
    with open(path, "r", encoding="utf-8") as f:
        return _parse_txt(f)


def write_binary(model, path) -> None:
    """Google word2vec C binary format. Words containing spaces are
    written with '_' in their place (the word2vec phrases convention —
    the space is the field terminator in this format)."""
    cache, m = _resolve(model)
    with open(path, "wb") as f:
        f.write(f"{m.shape[0]} {m.shape[1]}\n".encode())
        for i in range(m.shape[0]):
            word = cache.word_at(i).replace(" ", "_")
            f.write(word.encode("utf-8") + b" ")
            f.write(m[i].astype("<f4").tobytes())
            f.write(b"\n")


def load_binary(path) -> Tuple[VocabCache, np.ndarray]:
    with open(path, "rb") as f:
        header = f.readline().split()
        v, d = int(header[0]), int(header[1])
        cache = VocabCache()
        m = np.zeros((v, d), np.float32)
        for i in range(v):
            word = bytearray()
            while True:
                ch = f.read(1)
                if ch in (b" ", b""):
                    break
                word.extend(ch)
            cache.add(VocabWord(word.decode("utf-8")))
            m[i] = np.frombuffer(f.read(4 * d), "<f4")
            nl = f.read(1)
            if nl not in (b"\n", b""):
                # older files omit the newline; step back
                f.seek(-1, 1)
    return cache, m


_FULL_MODEL_KEYS = (
    "layer_size", "window", "learning_rate", "min_learning_rate",
    "negative", "sample", "epochs", "iterations", "batch_size",
    "seed", "algorithm",
)


def write_full_model(model, path) -> None:
    """Checkpoint a SequenceVectors/Word2Vec with its FULL training
    state (reference ``WordVectorSerializer.writeFullModel``): both
    weight tables, the Huffman coding, and per-word counts — enough to
    resume ``fit()`` with the alpha schedule and negative-sampling
    distribution intact."""
    import io

    cache = model.cache
    lk = model.lookup
    tables = {"syn0": _np(lk.syn0)}
    if lk.syn1 is not None:
        tables["syn1"] = _np(lk.syn1)
    if lk.syn1neg is not None:
        tables["syn1neg"] = _np(lk.syn1neg)
    if model.use_hs:
        tables["huffman_codes"] = np.asarray(model._codes)
        tables["huffman_points"] = np.asarray(model._points)
        tables["huffman_code_lens"] = np.asarray(model._code_lens)
    conf = {
        "format": "deeplearning4j_tpu.full_word2vec.1",
        "class": type(model).__name__,
        "use_hierarchic_softmax": model.use_hs,
        **{k: getattr(model, k) for k in _FULL_MODEL_KEYS},
    }
    vocab = {
        "total_word_count": cache.total_word_count,
        "words": [[w.word, int(w.count)] for w in cache.words],
    }
    buf = io.BytesIO()
    np.savez(buf, **tables)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("config.json", json.dumps(conf))
        z.writestr("vocab.json", json.dumps(vocab))
        z.writestr("tables.npz", buf.getvalue())


def load_full_model(path, sequences: Optional[list] = None, device=None):
    """Restore a full word2vec checkpoint. Returns a ``Word2Vec``
    (or base ``SequenceVectors``) whose next ``fit()`` continues from
    the saved tables; pass ``sequences`` (id arrays) to resume
    training on a corpus (reference ``loadFullModel``). ``device``:
    where the tables go (default ``"cuda"``)."""
    import io

    from deeplearning4j_tpu_torch.nlp.word2vec import SequenceVectors, Word2Vec

    with zipfile.ZipFile(path, "r") as z:
        conf = json.loads(z.read("config.json"))
        if not str(conf.get("format", "")).startswith(
            "deeplearning4j_tpu.full_word2vec."
        ):
            raise ValueError(
                f"{path} is not a full word2vec checkpoint"
            )
        vocab = json.loads(z.read("vocab.json"))
        tables = np.load(io.BytesIO(z.read("tables.npz")))
        tables = {k: tables[k] for k in tables.files}
    cache = VocabCache()
    for word, count in vocab["words"]:
        cache.add(VocabWord(word, count))
    cache.total_word_count = vocab["total_word_count"]
    kw = {k: conf[k] for k in _FULL_MODEL_KEYS}
    kw["use_hierarchic_softmax"] = conf["use_hierarchic_softmax"]
    if conf["class"] == "Word2Vec":
        model = Word2Vec(cache, sequences or [], device=device, **kw)
    else:
        model = SequenceVectors(cache, device=device, **kw)
        if sequences is not None:
            model._seqs = sequences
            model._sequences = lambda: iter(model._seqs)
    lk = model.lookup
    lk.load_numpy(tables["syn0"], tables.get("syn1"), tables.get("syn1neg"))
    if model.use_hs and "huffman_codes" in tables:
        model._codes = tables["huffman_codes"]
        model._points = tables["huffman_points"]
        model._code_lens = tables["huffman_code_lens"]
    lk.invalidate_norms()
    return model


def write_csv(model, path, sep: str = ",") -> None:
    """CSV interop (reference ``WordVectorSerializer`` CSV variant):
    one ``word,v1,...,vD`` row per word, no header. Words containing
    the separator are quoted per csv rules."""
    import csv

    cache, m = _resolve(model)
    with open(path, "w", encoding="utf-8", newline="") as f:
        w = csv.writer(f, delimiter=sep)
        for i in range(m.shape[0]):
            w.writerow([cache.word_at(i)]
                       + [repr(float(x)) for x in m[i]])


def load_csv(path, sep: str = ",") -> Tuple[VocabCache, np.ndarray]:
    """Headerless CSV has no declared dimensionality, so each row is
    validated against the first (the txt/bin loaders get this from
    their header)."""
    import csv

    cache = VocabCache()
    rows = []
    dim = None
    with open(path, "r", encoding="utf-8", newline="") as f:
        for lineno, parts in enumerate(csv.reader(f, delimiter=sep), 1):
            if not parts:
                continue
            vec = parts[1:]
            if dim is None:
                dim = len(vec)
                if dim == 0:
                    raise ValueError(
                        f"{path}:{lineno}: row {parts[0]!r} has no "
                        "vector components"
                    )
            elif len(vec) != dim:
                raise ValueError(
                    f"{path}:{lineno}: row {parts[0]!r} has "
                    f"{len(vec)} components, expected {dim}"
                )
            try:
                row = [float(x) for x in vec]
            except ValueError as e:
                raise ValueError(
                    f"{path}:{lineno}: non-numeric component in row "
                    f"{parts[0]!r}: {e}"
                ) from None
            cache.add(VocabWord(parts[0]))
            rows.append(row)
    if not rows:
        return cache, np.zeros((0, 0), np.float32)
    return cache, np.asarray(rows, np.float32)


def write_zip(model, path) -> None:
    """Zip-compressed text vectors (reference zip variant:
    ``words.txt`` inside a zip — the compressed interchange format for
    large vocabularies)."""
    import io

    cache, m = _resolve(model)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        buf = io.StringIO()
        buf.write(f"{m.shape[0]} {m.shape[1]}\n")
        for i in range(m.shape[0]):
            vals = " ".join(repr(float(x)) for x in m[i])
            buf.write(f"{cache.word_at(i)} {vals}\n")
        z.writestr("words.txt", buf.getvalue())


def load_zip(path) -> Tuple[VocabCache, np.ndarray]:
    import io

    with zipfile.ZipFile(path, "r") as z:
        data = z.read("words.txt").decode("utf-8")
    return _parse_txt(io.StringIO(data))


def write_word_vectors(model, path) -> None:
    """Dispatch on extension (.bin → binary, .csv → csv, .zip → zip,
    else txt) — reference ``writeWordVectors`` overloads."""
    p = str(path)
    if p.endswith(".bin"):
        write_binary(model, path)
    elif p.endswith(".csv"):
        write_csv(model, path)
    elif p.endswith(".zip"):
        write_zip(model, path)
    else:
        write_txt(model, path)


def read_word_vectors(path) -> Tuple[VocabCache, np.ndarray]:
    p = str(path)
    if p.endswith(".bin"):
        return load_binary(path)
    if p.endswith(".csv"):
        return load_csv(path)
    if p.endswith(".zip"):
        return load_zip(path)
    return load_txt(path)
