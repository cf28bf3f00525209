"""Text helpers the synthetic datasets share.

≙ paddle_tpu/data/common.py, trimmed to `tokenize` and `build_word_dict`,
the two that datasets.py calls. The downloader and its md5 cache are not
copied: the readers use real files only where they already lie under
DATA_HOME, and fall back to the synthetic generators otherwise.
"""

from __future__ import annotations

from ..core.enforce import InvalidArgumentError, enforce


def tokenize(text: str):
    """≙ reference imdb.tokenize: lowercase, strip punctuation, split."""
    import re
    return re.sub(r"[^a-z0-9\s]", "", text.lower()).split()


def build_word_dict(corpus_iter, min_word_freq: int = 0,
                    unk_token: str = "<unk>"):
    """Frequency-sorted word -> id dict (≙ imdb.build_dict /
    imikolov.build_dict): most frequent word gets id 0; words under
    min_word_freq drop out; unk_token appended last."""
    enforce(min_word_freq >= 0, "min_word_freq must be >= 0",
            exc=InvalidArgumentError)
    freq: dict = {}
    for tokens in corpus_iter:
        for t in tokens:
            freq[t] = freq.get(t, 0) + 1
    items = [(w, c) for w, c in freq.items()
             if c >= min_word_freq and w != unk_token]
    items.sort(key=lambda wc: (-wc[1], wc[0]))
    word_idx = {w: i for i, (w, _) in enumerate(items)}
    word_idx[unk_token] = len(word_idx)
    return word_idx
