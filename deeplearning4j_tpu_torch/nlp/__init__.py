"""NLP / embeddings subsystem (reference: ``deeplearning4j-nlp-parent``):
the tokenization pipeline, vocabulary construction, Word2Vec / GloVe /
ParagraphVectors and word-vector serialization.

Counterpart of ``deeplearning4j_tpu/nlp``. The reference trains
hogwild — N threads racing on shared syn0/syn1
(``SequenceVectors.java:935,:1029``); here, as in the JAX package, the
host packs (center, context, negatives) into fixed-shape batches and
one step applies gather -> dot -> sigmoid -> row update for the whole
batch (synchronous large-batch updates: parity with the reference is
statistical). The bag-of-words / TF-IDF vectorizers, the inverted
index, ``StaticWord2Vec`` and the model utilities (flat and VP-tree
nearest words) are here too, and the host-only text periphery: the CJK
tokenizers (``cjk.py``: script-class segmentation, registered as
``"japanese_script"`` and ``"korean"``), the Japanese lattice and Viterbi
segmenter (``japanese.py``, registered as ``"japanese"``), the tree
parser (``treeparser.py``: sentence segmentation, Porter stemming,
``Tree``, ``TreeParser``, ``TreeVectorizer``) and the averaged-perceptron
POS tagger (``pos_tagger.py``).
"""

from deeplearning4j_tpu_torch.nlp import cjk  # noqa: F401 (registers ja/ko)
from deeplearning4j_tpu_torch.nlp import japanese  # noqa: F401 (dictionary)

from deeplearning4j_tpu_torch.nlp.glove import Glove
from deeplearning4j_tpu_torch.nlp.inverted_index import InvertedIndex
from deeplearning4j_tpu_torch.nlp.model_utils import (
    BasicModelUtils,
    FlatModelUtils,
    TreeModelUtils,
)
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import ParagraphVectors
from deeplearning4j_tpu_torch.nlp.serializer import (
    load_binary,
    load_txt,
    read_word_vectors,
    write_binary,
    write_txt,
    write_word_vectors,
)
from deeplearning4j_tpu_torch.nlp.static_word2vec import (
    StaticWord2Vec,
    save_static,
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
from deeplearning4j_tpu_torch.nlp.treeparser import (
    Tree,
    TreeParser,
    TreeVectorizer,
    porter_stem,
    pos_tag,
    segment_sentences,
)
from deeplearning4j_tpu_torch.nlp.vectorizers import (
    BagOfWordsVectorizer,
    TfidfVectorizer,
)
from deeplearning4j_tpu_torch.nlp.vocab import (
    Huffman,
    VocabCache,
    VocabConstructor,
    VocabWord,
)
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

__all__ = [
    "BagOfWordsVectorizer", "BasicModelUtils", "CharTokenizerFactory",
    "CollectionSentenceIterator", "DefaultTokenizerFactory",
    "FileSentenceIterator", "FlatModelUtils", "Glove", "Huffman",
    "InvertedIndex", "LineSentenceIterator", "NGramTokenizerFactory",
    "ParagraphVectors", "RegexTokenizerFactory", "StaticWord2Vec",
    "TfidfVectorizer", "Tree", "TreeModelUtils", "TreeParser",
    "TreeVectorizer", "VocabCache", "VocabConstructor", "VocabWord",
    "Word2Vec", "load_binary", "load_txt", "porter_stem", "pos_tag",
    "read_word_vectors", "register_tokenizer_factory", "save_static",
    "segment_sentences", "tokenizer_factory", "write_binary", "write_txt",
    "write_word_vectors",
]
