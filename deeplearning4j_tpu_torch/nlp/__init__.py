"""NLP / embeddings subsystem (reference: ``deeplearning4j-nlp-parent``):
the tokenization pipeline, vocabulary construction, Word2Vec / GloVe /
ParagraphVectors and word-vector serialization.

Counterpart of ``deeplearning4j_tpu/nlp``. The reference trains
hogwild — N threads racing on shared syn0/syn1
(``SequenceVectors.java:935,:1029``); here, as in the JAX package, the
host packs (center, context, negatives) into fixed-shape batches and
one step applies gather -> dot -> sigmoid -> row update for the whole
batch (synchronous large-batch updates: parity with the reference is
statistical). The CJK / Japanese segmenters, the tree parser and POS
tagger, the vectorizers, the inverted index, ``StaticWord2Vec`` and
the model utilities are not ported yet (ROADMAP queue 1).
"""

from deeplearning4j_tpu_torch.nlp.glove import Glove
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import ParagraphVectors
from deeplearning4j_tpu_torch.nlp.serializer import (
    load_binary,
    load_txt,
    read_word_vectors,
    write_binary,
    write_txt,
    write_word_vectors,
)
from deeplearning4j_tpu_torch.nlp.tokenization import (
    CharTokenizerFactory,
    CollectionSentenceIterator,
    DefaultTokenizerFactory,
    FileSentenceIterator,
    LineSentenceIterator,
    NGramTokenizerFactory,
    RegexTokenizerFactory,
    register_tokenizer_factory,
    tokenizer_factory,
)
from deeplearning4j_tpu_torch.nlp.vocab import (
    Huffman,
    VocabCache,
    VocabConstructor,
    VocabWord,
)
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

__all__ = [
    "CharTokenizerFactory", "CollectionSentenceIterator",
    "DefaultTokenizerFactory", "FileSentenceIterator", "Glove", "Huffman",
    "LineSentenceIterator", "NGramTokenizerFactory", "ParagraphVectors",
    "RegexTokenizerFactory", "VocabCache", "VocabConstructor", "VocabWord",
    "Word2Vec", "load_binary", "load_txt", "read_word_vectors",
    "register_tokenizer_factory", "tokenizer_factory", "write_binary",
    "write_txt", "write_word_vectors",
]
