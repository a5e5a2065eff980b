"""[Copy of ``dropoutdecoding_tpu/evalsuite/text.py``, held against it by
tests/test_torch_evalsuite.py: the port imports nothing of the JAX package.]

Tokenization + singularization without external data downloads.

The reference calls nltk.word_tokenize (needs the punkt model, not
downloadable here) and pattern.en.singularize (py3.10-fragile, absent) —
chair.py:155-156.  These are replaced by:

- ``word_tokenize``: NLTK's TreebankWordTokenizer applied per caption (the
  algorithmic tokenizer behind word_tokenize; punkt is only needed for the
  sentence-splitting step, which we perform with a regex).  Falls back to a
  built-in PTB-style regex tokenizer if nltk is unavailable.
- ``singularize``: rule-based English singularizer covering the inflection
  classes that occur in COCO object vocabulary (tested against the COCO
  synonym list in tests/test_chair.py).
"""
from __future__ import annotations

import re

try:  # nltk is present in this image; its Treebank tokenizer is data-free
    from nltk.tokenize import TreebankWordTokenizer

    _TREEBANK = TreebankWordTokenizer()
except Exception:  # pragma: no cover
    _TREEBANK = None

_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")
_FALLBACK_TOKEN = re.compile(r"[a-zA-Z]+|[0-9]+|[^\sa-zA-Z0-9]")


def word_tokenize(text: str) -> list:
    if _TREEBANK is not None:
        tokens = []
        for sent in _SENT_SPLIT.split(text):
            tokens.extend(_TREEBANK.tokenize(sent))
        return tokens
    return _FALLBACK_TOKEN.findall(text)


# --- singularization ---------------------------------------------------------
# Faithful reimplementation of pattern.en.singularize's behavior, which the
# CHAIR metric is *defined* through (reference chair.py:6,156).  pattern's
# singularizer is famously aggressive — it mangles non-plurals ('has'->'ha',
# 'glass'->'glas', 'slice'->'slouse', 'bus'->'bu') — and those quirks shape
# which object mentions the metric sees, so they are replicated, not fixed.
# Validated against ~3.5k distinct token mappings mined from the reference's
# archived results (tests/test_chair_reference_parity.py).

import re as _re

_SINGULAR_RULES = [
    (r"(?i)(.)ae$", "\\1a"),
    (r"(?i)(.)itis$", "\\1itis"),
    (r"(?i)(.)eaux$", "\\1eau"),
    (r"(?i)(quiz)zes$", "\\1"),
    (r"(?i)(matr)ices$", "\\1ix"),
    (r"(?i)(ap|vert|ind)ices$", "\\1ex"),
    (r"(?i)^(ox)en", "\\1"),
    (r"(?i)(alias|status)es$", "\\1"),
    (r"(?i)([octop|vir])i$", "\\1us"),
    (r"(?i)(cris|ax|test)es$", "\\1is"),
    (r"(?i)(shoe)s$", "\\1"),
    (r"(?i)(o)es$", "\\1"),
    (r"(?i)(bus)es$", "\\1"),
    (r"(?i)([m|l])ice$", "\\1ouse"),
    (r"(?i)(x|ch|ss|sh)es$", "\\1"),
    (r"(?i)(m)ovies$", "\\1ovie"),
    (r"(?i)(.)ombies$", "\\1ombie"),
    (r"(?i)(s)eries$", "\\1eries"),
    (r"(?i)([^aeiouy]|qu)ies$", "\\1y"),
    (r"(?i)([aeo]l)ves$", "\\1f"),
    (r"(?i)([^d]ea)ves$", "\\1f"),
    (r"(?i)(ar)ves$", "\\1f"),
    (r"(?i)(erve)s$", "\\1"),
    (r"(?i)([nlw]i)ves$", "\\1fe"),
    (r"(?i)([lr])ves$", "\\1f"),
    (r"(?i)([aeo])ves$", "\\1ve"),
    (r"(?i)(sive)s$", "\\1"),
    (r"(?i)(tive)s$", "\\1"),
    (r"(?i)(hive)s$", "\\1"),
    (r"(?i)([^f])ves$", "\\1fe"),
    (r"(?i)(^analy)ses$", "\\1sis"),
    (r"(?i)((a)naly|(b)a|(d)iagno|(p)arenthe|(p)rogno|(s)ynop|(t)he)ses$", "\\1\\2sis"),
    (r"(?i)(.)opses$", "\\1opsis"),
    (r"(?i)(.)yses$", "\\1ysis"),
    (r"(?i)(h|d|r|o|n|b|cl|p)oses$", "\\1ose"),
    (r"(?i)(fruct|gluc|galact|lact|ket|malt|rib|sacchar|cellul)ose$", "\\1ose"),
    (r"(?i)(.)oses$", "\\1osis"),
    (r"(?i)([ti])a$", "\\1um"),
    (r"(?i)(n)ews$", "\\1ews"),
    (r"(?i)s$", ""),
]
_RULES = [(_re.compile(p), r) for p, r in _SINGULAR_RULES]
_UNINFLECTED = [
    "bison", "bream", "breeches", "britches", "carp", "chassis", "christmas",
    "clippers", "cod", "contretemps", "corps", "debris", "diabetes", "djinn",
    "eland", "elk", "flounder", "gallows", "graffiti", "headquarters",
    "herpes", "high-jinks", "homework", "innings", "jackanapes", "mackerel",
    "measles", "mews", "mumps", "news", "pincers", "pliers", "proceedings",
    "rabies", "salmon", "scissors", "series", "shears", "species", "swine",
    "trout", "tuna", "whiting", "wildebeest",
]
_UNCOUNTABLE = [
    "advice", "bread", "butter", "cheese", "electricity", "equipment",
    "fruit", "furniture", "garbage", "gravel", "happiness", "information",
    "ketchup", "knowledge", "love", "luggage", "mathematics", "mayonnaise",
    "meat", "mustard", "news", "progress", "research", "rice", "sand",
    "software", "understanding", "water",
]
_IE = [
    "alergie", "cutie", "hoagie", "newbie", "softie", "veggie", "auntie",
    "budgie", "caddie", "cookie", "genie", "lassie", "freebie",
]
_IRREGULAR = {
    "atlantes": "atlas", "atlases": "atlas", "axes": "axe", "beeves": "beef",
    "brethren": "brother", "children": "child", "corpora": "corpus",
    "corpuses": "corpus", "ephemerides": "ephemeris", "feet": "foot",
    "ganglia": "ganglion", "geese": "goose", "genera": "genus",
    "genii": "genie", "graffiti": "graffito", "helves": "helve",
    "kine": "cow", "leaves": "leaf", "loaves": "loaf", "men": "man",
    "mongooses": "mongoose", "monies": "money", "moves": "move",
    "mythoi": "mythos", "numena": "numen", "occipita": "occiput",
    "octopodes": "octopus", "opera": "opus", "opuses": "opus", "our": "my",
    "oxen": "ox", "penes": "penis", "penises": "penis", "people": "person",
    "sexes": "sex", "soliloquies": "soliloquy", "teeth": "tooth",
    "testes": "testis", "trilbys": "trilby", "turves": "turf", "zoa": "zoon",
}


_PREPOSITIONS = {
    "about", "above", "across", "after", "among", "around", "at", "athwart",
    "before", "behind", "below", "beneath", "beside", "besides", "between",
    "betwixt", "beyond", "but", "by", "during", "except", "for", "from",
    "in", "into", "near", "of", "off", "on", "onto", "out", "over", "since",
    "till", "to", "under", "until", "unto", "upon", "with",
}


def singularize(word: str) -> str:
    if "-" in word:
        # pattern's compound handling: 'mothers-in-law'-style words (second
        # part a preposition) inflect the head; otherwise the last part
        parts = word.split("-")
        if len(parts) > 1 and parts[1] in _PREPOSITIONS:
            return "-".join([singularize(parts[0])] + parts[1:])
        return "-".join(parts[:-1] + [singularize(parts[-1])])
    if word.endswith("'"):
        return singularize(word[:-1]) + "'s"
    w = word.lower()
    for x in _UNINFLECTED:
        if x.endswith(w):
            return word
    for x in _UNCOUNTABLE:
        if x.endswith(w):
            return word
    for x in _IE:
        if w.endswith(x + "s"):
            return w
    for x, s in _IRREGULAR.items():
        if w.endswith(x):
            return _re.sub("(?i)" + x + "$", s, word)
    for rx, repl in _RULES:
        if rx.search(word):
            return rx.sub(repl, word)
    return word
