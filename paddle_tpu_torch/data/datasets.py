"""Builtin datasets.

≙ paddle_tpu/data/datasets.py, a copy (the module imports numpy only; the
port keeps its own so it imports nothing of the JAX package), ≙ reference
python/paddle/dataset/ (mnist, cifar, imdb, uci_housing, imikolov, ...).
Each dataset is backed by a deterministic synthetic generator with the same
sample shapes and reader contract; if the real files exist under
PTPU_DATA_HOME they are used instead (nothing is downloaded). The reader
API (train()/test() -> reader) matches the reference.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Callable

import numpy as np

DATA_HOME = os.environ.get("PTPU_DATA_HOME",
                           os.path.expanduser("~/.cache/paddle_tpu/dataset"))


def _synthetic_images(n, shape, classes, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(int(np.prod(shape)), classes).astype(np.float32)

    def reader():
        r = np.random.RandomState(seed + 1)
        for _ in range(n):
            x = r.rand(*shape).astype(np.float32)
            y = int(np.argmax(x.reshape(-1) @ w))
            yield x, y

    return reader


# ------------------------------------------------------------------ mnist
def _mnist_files_exist():
    d = os.path.join(DATA_HOME, "mnist")
    return all(os.path.exists(os.path.join(d, f)) for f in
               ["train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"])


def _read_mnist(img_path, lbl_path):
    with gzip.open(lbl_path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), dtype=np.uint8)
    with gzip.open(img_path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        images = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows * cols)
    images = images.astype(np.float32) / 127.5 - 1.0

    def reader():
        for i in range(n):
            yield images[i], int(labels[i])

    return reader


class mnist:
    """≙ paddle.dataset.mnist — 784-dim float images in [-1,1], int label."""

    @staticmethod
    def train() -> Callable:
        if _mnist_files_exist():
            d = os.path.join(DATA_HOME, "mnist")
            return _read_mnist(os.path.join(d, "train-images-idx3-ubyte.gz"),
                               os.path.join(d, "train-labels-idx1-ubyte.gz"))
        return _synthetic_images(8192, (784,), 10, seed=7)

    @staticmethod
    def test() -> Callable:
        if _mnist_files_exist():
            d = os.path.join(DATA_HOME, "mnist")
            return _read_mnist(os.path.join(d, "t10k-images-idx3-ubyte.gz"),
                               os.path.join(d, "t10k-labels-idx1-ubyte.gz"))
        return _synthetic_images(1024, (784,), 10, seed=8)


def _read_cifar_tar(tar_path, member_substr, label_key=b"labels"):
    """Parse the REAL CIFAR python pickle format: a tar.gz whose members
    hold pickled dicts {b'data': [N, 3072] uint8, b'labels'/b'fine_labels':
    [N]} (≙ reference dataset/cifar.py reader_creator). Images normalize
    to float32 / 255."""
    import pickle
    import tarfile

    def reader():
        with tarfile.open(tar_path, "r:*") as tf:
            for m in sorted(tf.getnames()):
                if member_substr not in os.path.basename(m):
                    continue
                f = tf.extractfile(m)
                if f is None:
                    continue
                batch = pickle.loads(f.read(), encoding="bytes")
                data = np.asarray(batch[b"data"], np.uint8)
                labels = batch.get(label_key, batch.get(b"labels"))
                for x, y in zip(data, labels):
                    yield x.astype(np.float32) / 255.0, int(y)

    return reader


def _cifar_tar(name):
    p = os.path.join(DATA_HOME, "cifar", name)
    return p if os.path.exists(p) else None


class cifar:
    """≙ paddle.dataset.cifar — 3x32x32 images. Real CIFAR-10/100 python
    pickle tars are parsed when present under <DATA_HOME>/cifar/;
    synthetic stand-ins otherwise."""

    TAR10 = "cifar-10-python.tar.gz"
    TAR100 = "cifar-100-python.tar.gz"

    @staticmethod
    def train10():
        tar = _cifar_tar(cifar.TAR10)
        if tar:
            return _read_cifar_tar(tar, "data_batch")
        return _synthetic_images(8192, (3 * 32 * 32,), 10, seed=17)

    @staticmethod
    def test10():
        tar = _cifar_tar(cifar.TAR10)
        if tar:
            return _read_cifar_tar(tar, "test_batch")
        return _synthetic_images(1024, (3 * 32 * 32,), 10, seed=18)

    @staticmethod
    def train100():
        tar = _cifar_tar(cifar.TAR100)
        if tar:
            return _read_cifar_tar(tar, "train", label_key=b"fine_labels")
        return _synthetic_images(8192, (3 * 32 * 32,), 100, seed=19)


class uci_housing:
    """≙ paddle.dataset.uci_housing — 13 features, scalar target."""

    @staticmethod
    def train():
        rng = np.random.RandomState(3)
        w = rng.randn(13).astype(np.float32)

        def reader():
            r = np.random.RandomState(4)
            for _ in range(404):
                x = r.rand(13).astype(np.float32)
                y = float(x @ w + 0.05 * r.randn())
                yield x, np.array([y], dtype=np.float32)

        return reader

    @staticmethod
    def test():
        rng = np.random.RandomState(3)
        w = rng.randn(13).astype(np.float32)

        def reader():
            r = np.random.RandomState(5)
            for _ in range(102):
                x = r.rand(13).astype(np.float32)
                yield x, np.array([float(x @ w)], dtype=np.float32)

        return reader


def _imdb_tar():
    p = os.path.join(DATA_HOME, "imdb", "aclImdb_v1.tar.gz")
    return p if os.path.exists(p) else None


def _read_imdb_tar(tar_path, pattern, word_dict):
    """Parse the REAL aclImdb layout: tar.gz of <split>/<pos|neg>/<id>.txt
    review files (≙ reference dataset/imdb.py reader_creator). pos -> 0,
    neg -> 1, as in the reference."""
    import re
    import tarfile

    from .common import tokenize
    unk = word_dict.get("<unk>", len(word_dict) - 1)
    rx = re.compile(pattern)

    def reader():
        with tarfile.open(tar_path, "r:*") as tf:
            for m in sorted(tf.getnames()):
                if not rx.search(m):
                    continue
                f = tf.extractfile(m)
                if f is None:
                    continue
                toks = tokenize(f.read().decode("utf-8", "replace"))
                ids = np.asarray([word_dict.get(t, unk) for t in toks],
                                 np.int64)
                if ids.size == 0:
                    continue
                yield ids, (0 if "/pos/" in m else 1)

    return reader


def _imdb_build_dict(tar_path, min_word_freq=5):
    import re
    import tarfile

    from .common import build_word_dict, tokenize

    def corpus():
        rx = re.compile(r"train/(pos|neg)/.*\.txt$")
        with tarfile.open(tar_path, "r:*") as tf:
            for m in tf.getnames():
                if rx.search(m):
                    f = tf.extractfile(m)
                    if f is not None:
                        yield tokenize(f.read().decode("utf-8", "replace"))

    return build_word_dict(corpus(), min_word_freq=min_word_freq)


class imdb:
    """≙ paddle.dataset.imdb — variable-length word-id sequences, binary
    label. The real aclImdb tar is parsed when present under
    <DATA_HOME>/imdb/ (word dict built from the train split, frequency
    sorted, ≙ reference imdb.build_dict); synthetic class-dependent
    unigram distributions otherwise."""

    word_dict_size = 5148

    @staticmethod
    def word_dict(min_word_freq=5):
        tar = _imdb_tar()
        if tar:
            return _imdb_build_dict(tar, min_word_freq)
        return {i: i for i in range(imdb.word_dict_size)}

    @staticmethod
    def _make(seed, n):
        def reader():
            r = np.random.RandomState(seed)
            v = imdb.word_dict_size
            for _ in range(n):
                label = int(r.rand() > 0.5)
                length = int(r.randint(20, 200))
                center = v // 4 if label == 0 else 3 * v // 4
                ids = np.clip(r.normal(center, v // 8, length), 0, v - 1) \
                    .astype(np.int64)
                yield ids, label

        return reader

    @staticmethod
    def train(word_dict=None):
        tar = _imdb_tar()
        if tar:
            wd = word_dict if word_dict is not None else imdb.word_dict()
            return _read_imdb_tar(tar, r"train/(pos|neg)/.*\.txt$", wd)
        return imdb._make(11, 2048)

    @staticmethod
    def test(word_dict=None):
        tar = _imdb_tar()
        if tar:
            wd = word_dict if word_dict is not None else imdb.word_dict()
            return _read_imdb_tar(tar, r"test/(pos|neg)/.*\.txt$", wd)
        return imdb._make(12, 512)


def _imikolov_file(split):
    p = os.path.join(DATA_HOME, "imikolov", f"ptb.{split}.txt")
    return p if os.path.exists(p) else None


def _read_imikolov_text(path, word_dict, n):
    """Parse the REAL PTB text format: one sentence per line, wrapped in
    <s>/<e> markers, emitted as sliding n-grams of word ids (≙ reference
    dataset/imikolov.py reader_creator with DataType.NGRAM)."""
    unk = word_dict.get("<unk>", len(word_dict) - 1)

    def reader():
        with open(path, encoding="utf-8") as f:
            for line in f:
                words = ["<s>"] + line.split() + ["<e>"]
                ids = [word_dict.get(w, unk) for w in words]
                for i in range(n, len(ids) + 1):
                    yield tuple(ids[i - n:i])

    return reader


class imikolov:
    """≙ paddle.dataset.imikolov — PTB-style n-gram language model data.
    Real ptb.<split>.txt files are parsed when present under
    <DATA_HOME>/imikolov/; synthetic markov-ish n-grams otherwise."""

    vocab_size = 2074

    @staticmethod
    def build_dict(min_word_freq=50):
        path = _imikolov_file("train")
        if path:
            from .common import build_word_dict

            def corpus():
                with open(path, encoding="utf-8") as f:
                    for line in f:
                        yield ["<s>"] + line.split() + ["<e>"]

            return build_word_dict(corpus(), min_word_freq=min_word_freq)
        return {i: i for i in range(imikolov.vocab_size)}

    @staticmethod
    def _make(seed, n, ngram):
        def reader():
            r = np.random.RandomState(seed)
            v = imikolov.vocab_size
            # markov-ish: next word correlated with sum of context
            for _ in range(n):
                ctx = r.randint(0, v, size=ngram - 1)
                nxt = int((ctx.sum() * 31 + r.randint(0, 7)) % v)
                yield tuple(int(c) for c in ctx) + (nxt,)

        return reader

    @staticmethod
    def train(word_dict=None, n=5):
        path = _imikolov_file("train")
        if path:
            wd = word_dict if word_dict is not None \
                else imikolov.build_dict()
            return _read_imikolov_text(path, wd, n)
        return imikolov._make(21, 4096, n)

    @staticmethod
    def test(word_dict=None, n=5):
        path = _imikolov_file("valid")
        if path:
            wd = word_dict if word_dict is not None \
                else imikolov.build_dict()
            return _read_imikolov_text(path, wd, n)
        return imikolov._make(22, 512, n)


class ptb:
    """PTB-style token stream for the stacked-LSTM LM benchmark."""

    vocab_size = 10000

    @staticmethod
    def train(seq_len=20, n=2048):
        def reader():
            r = np.random.RandomState(31)
            for _ in range(n):
                seq = r.randint(0, ptb.vocab_size, size=seq_len + 1)
                yield seq[:-1].astype(np.int64), seq[1:].astype(np.int64)

        return reader


class wmt_synthetic:
    """Synthetic parallel corpus for the Transformer NMT benchmark
    (≙ paddle.dataset.wmt14/wmt16 shapes)."""

    src_vocab = 10000
    trg_vocab = 10000
    bos, eos = 0, 1

    @staticmethod
    def train(n=2048, max_len=30, seed=41):
        def reader():
            r = np.random.RandomState(seed)
            for _ in range(n):
                slen = int(r.randint(5, max_len))
                src = r.randint(2, wmt_synthetic.src_vocab, size=slen)
                trg = (src[:max(1, slen - 1)] + 7) % wmt_synthetic.trg_vocab
                trg = np.clip(trg, 2, None)
                yield (src.astype(np.int64),
                       np.concatenate([[wmt_synthetic.bos], trg]).astype(np.int64),
                       np.concatenate([trg, [wmt_synthetic.eos]]).astype(np.int64))

        return reader


class ctr_synthetic:
    """Synthetic CTR data (sparse id features + dense) for DeepFM/Wide&Deep
    (≙ the distributed-lookup-table workload, SURVEY §2.3)."""

    @staticmethod
    def train(n=4096, num_fields=26, vocab_per_field=1000, dense_dim=13):
        def reader():
            r = np.random.RandomState(51)
            w_sparse = np.random.RandomState(52).randn(num_fields)
            w_dense = np.random.RandomState(53).randn(dense_dim)
            for _ in range(n):
                sparse = r.randint(0, vocab_per_field, size=num_fields)
                dense = r.rand(dense_dim).astype(np.float32)
                logit = (sparse / vocab_per_field - 0.5) @ w_sparse + \
                    dense @ w_dense
                label = int(logit + 0.3 * r.randn() > 0)
                yield sparse.astype(np.int64), dense, label

        return reader


# ------------------------------------------------------------- flowers
class flowers:
    """≙ reference dataset/flowers.py (102-category Oxford flowers):
    224x224x3 images + label."""

    NUM_CLASSES = 102

    @staticmethod
    def train(n=512):
        return _synthetic_images(n, (3, 224, 224), flowers.NUM_CLASSES, 101)

    @staticmethod
    def test(n=128):
        return _synthetic_images(n, (3, 224, 224), flowers.NUM_CLASSES, 102)

    valid = test


# ----------------------------------------------------------- movielens
class movielens:
    """≙ reference dataset/movielens.py: (user_id, gender, age, job,
    movie_id, category vec, title vec) -> rating."""

    MAX_USER = 6040
    MAX_MOVIE = 3952
    NUM_JOBS = 21
    NUM_AGES = 7
    NUM_CATEGORIES = 18
    TITLE_LEN = 10
    TITLE_VOCAB = 5000

    @staticmethod
    def _reader(n, seed):
        def reader():
            r = np.random.RandomState(seed)
            for _ in range(n):
                user = r.randint(1, movielens.MAX_USER + 1)
                gender = r.randint(0, 2)
                age = r.randint(0, movielens.NUM_AGES)
                job = r.randint(0, movielens.NUM_JOBS)
                movie = r.randint(1, movielens.MAX_MOVIE + 1)
                cats = r.randint(0, movielens.NUM_CATEGORIES,
                                 (r.randint(1, 4),))
                title = r.randint(0, movielens.TITLE_VOCAB,
                                  (movielens.TITLE_LEN,))
                # learnable structure: rating depends on ids
                rating = float((user * 7 + movie * 3) % 5 + 1)
                yield (user, gender, age, job, movie, cats, title, rating)
        return reader

    @staticmethod
    def train(n=2048):
        return movielens._reader(n, 201)

    @staticmethod
    def test(n=512):
        return movielens._reader(n, 202)

    @staticmethod
    def max_user_id():
        return movielens.MAX_USER

    @staticmethod
    def max_movie_id():
        return movielens.MAX_MOVIE

    @staticmethod
    def max_job_id():
        return movielens.NUM_JOBS - 1

    @staticmethod
    def age_table():
        return [1, 18, 25, 35, 45, 50, 56]


# -------------------------------------------------------------- conll05
class conll05:
    """≙ reference dataset/conll05.py (semantic role labeling). Yields the
    reference's 9 slots: (word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2,
    predicate, mark, label) where ctx_* are the +-2 context windows around
    the predicate position broadcast over the sequence."""

    WORD_VOCAB = 4000
    LABEL_DICT_LEN = 59   # reference label dict size
    PRED_VOCAB = 3000

    @staticmethod
    def get_dict():
        word_dict = {f"w{i}": i for i in range(conll05.WORD_VOCAB)}
        verb_dict = {f"v{i}": i for i in range(conll05.PRED_VOCAB)}
        label_dict = {f"l{i}": i for i in range(conll05.LABEL_DICT_LEN)}
        return word_dict, verb_dict, label_dict

    @staticmethod
    def _reader(n, seed, max_len=30):
        def reader():
            r = np.random.RandomState(seed)
            for _ in range(n):
                t = int(r.randint(5, max_len + 1))
                words = r.randint(0, conll05.WORD_VOCAB, (t,))
                pred_pos = int(r.randint(0, t))
                pred = r.randint(0, conll05.PRED_VOCAB)
                # +-2 context window around the predicate, broadcast over
                # the sequence (the reference's ctx_n2..ctx_p2 slots)
                def ctx(offset):
                    j = min(max(pred_pos + offset, 0), t - 1)
                    return np.full((t,), words[j], dtype=np.int64)
                mark = np.zeros((t,), dtype=np.int64)
                mark[pred_pos] = 1
                labels = (words * 31 + pred) % conll05.LABEL_DICT_LEN
                yield (words, ctx(-2), ctx(-1), ctx(0), ctx(1), ctx(2),
                       pred, mark, labels)
        return reader

    @staticmethod
    def train(n=1024):
        return conll05._reader(n, 301)

    @staticmethod
    def test(n=256):
        return conll05._reader(n, 302)


# ------------------------------------------------------------ sentiment
class sentiment:
    """≙ reference dataset/sentiment.py (NLTK movie reviews): token id
    sequence -> 0/1 polarity."""

    VOCAB = 5000

    @staticmethod
    def get_word_dict():
        return {f"tok{i}": i for i in range(sentiment.VOCAB)}

    @staticmethod
    def _reader(n, seed):
        def reader():
            r = np.random.RandomState(seed)
            pos = r.permutation(sentiment.VOCAB)[:sentiment.VOCAB // 2]
            pos_set = set(int(x) for x in pos)
            for _ in range(n):
                t = r.randint(8, 60)
                toks = r.randint(0, sentiment.VOCAB, (t,))
                score = sum(1 if int(x) in pos_set else -1 for x in toks)
                yield toks, int(score > 0)
        return reader

    @staticmethod
    def train(n=1024):
        return sentiment._reader(n, 401)

    @staticmethod
    def test(n=256):
        return sentiment._reader(n, 402)


# -------------------------------------------------------------- voc2012
class voc2012:
    """≙ reference dataset/voc2012.py (segmentation): image [3,H,W] +
    dense label map [H,W] with 21 classes."""

    NUM_CLASSES = 21

    @staticmethod
    def _reader(n, seed, size=128):
        def reader():
            r = np.random.RandomState(seed)
            for _ in range(n):
                img = r.rand(3, size, size).astype(np.float32)
                # blocky label map correlated with intensity (learnable)
                lbl = (img.mean(0) * voc2012.NUM_CLASSES).astype(np.int64)
                lbl = np.clip(lbl, 0, voc2012.NUM_CLASSES - 1)
                yield img, lbl
        return reader

    @staticmethod
    def train(n=256):
        return voc2012._reader(n, 501)

    @staticmethod
    def test(n=64):
        return voc2012._reader(n, 502)

    val = test


# ------------------------------------------------------------ wmt14/16
class wmt14:
    """≙ reference dataset/wmt14.py: (src ids, tgt ids, tgt_next ids)."""

    DICT_SIZE = 30000

    @staticmethod
    def train(dict_size=DICT_SIZE, n=2048, max_len=30):
        return wmt_synthetic.train(n=n, max_len=max_len)

    @staticmethod
    def test(dict_size=DICT_SIZE, n=512, max_len=30):
        # distinct stream from train (seed 42 vs 41): evaluating on
        # training samples would silently inflate metrics
        return wmt_synthetic.train(n=n, max_len=max_len, seed=42)


class wmt16(wmt14):
    """≙ reference dataset/wmt16.py — same reader contract."""


# --------------------------------------------------------------- mq2007
class mq2007:
    """≙ reference dataset/mq2007.py (LETOR learning-to-rank): per query a
    list of (feature[46], relevance) pairs; pairwise/listwise modes."""

    FEATURE_DIM = 46

    @staticmethod
    def _reader(n_queries, seed, format="pairwise"):
        def reader():
            r = np.random.RandomState(seed)
            w = r.randn(mq2007.FEATURE_DIM).astype(np.float32)
            for _ in range(n_queries):
                docs = r.randint(5, 20)
                feats = r.rand(docs, mq2007.FEATURE_DIM).astype(np.float32)
                rel = ((feats @ w) > 0).astype(np.int64) + \
                    ((feats @ w) > 1).astype(np.int64)
                if format == "listwise":
                    yield feats, rel
                else:  # pairwise: yield (query-level) doc pairs d1 > d2
                    for i in range(docs):
                        for j in range(docs):
                            if rel[i] > rel[j]:
                                yield rel[i] - rel[j], feats[i], feats[j]
        return reader

    @staticmethod
    def train(format="pairwise", n_queries=128):
        return mq2007._reader(n_queries, 601, format)

    @staticmethod
    def test(format="pairwise", n_queries=32):
        return mq2007._reader(n_queries, 602, format)
