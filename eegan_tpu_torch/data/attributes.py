"""Attribute phrases parsed from captions: for ``--from_code``/``--from_txt``
sampling, and offline for a corpus's ``attributes/<name>.pickle``
(:func:`build_attributes_pickle`, ``python -m
eegan_tpu_torch.prepare_attributes``).

Copy of ``eegan_tpu/data/attributes.py`` with the hermetic lexicon tagger
(the port imports nothing of the JAX package).
Rebuilds `PrepareAttrs` (reference `prepare_attributes.py:44-327`): captions
are POS-tagged and chunked with per-dataset regex grammars; NP chunks
become attribute phrases; "split" grammars *subtract* noun-verb fragments.

The JAX package chunks with ``nltk.RegexpParser``. The port carries its own
:class:`RegexpChunker` with the same semantics for the grammars used here
(one ``LABEL: {tag pattern}`` chunk rule per line, each line one stage), so
sampling and the lexicon-mode pickle need no nltk. The Perceptron and Stanford taggers still come from
nltk and are imported only when asked for.

One deliberate difference: :meth:`AttributeExtractor.parse_caption` returns
the phrases sorted, where the JAX copy returns them in ``set`` order (which
varies with the interpreter's hash seed); the set of phrases is the same,
and so is every caption's list in an attributes pickle once sorted.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

# ---------------------------------------------------------------------------
# Hermetic fallback POS tagger
# ---------------------------------------------------------------------------

_DT = {"a", "an", "the", "this", "that", "these", "those", "all", "both",
       "some", "any", "each", "every", "no", "another"}
_PRP = {"it", "its", "his", "her", "their", "our", "my", "your", "he", "she",
        "they", "we", "i", "you"}
_IN = {"in", "on", "at", "of", "with", "from", "to", "over", "under", "above",
       "below", "near", "around", "across", "against", "along", "behind",
       "beside", "between", "by", "down", "into", "onto", "through", "toward",
       "towards", "up", "upon", "within", "atop", "outside", "inside"}
_CC = {"and", "or", "but", "nor"}
_WP = {"who", "whom", "what"}
_CD = {"one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
       "ten", "several", "couple"}
_BE_VBZ = {"is", "has", "looks", "appears", "seems", "contains", "features",
           "shows", "sits", "stands", "holds", "rides", "wears", "flies",
           "covers", "fades"}
_BE_VBP = {"are", "have", "look", "appear", "seem", "contain", "feature",
           "show", "sit", "stand", "hold", "ride", "wear", "fly", "cover"}
_VB = {"be"}
_RB = {"very", "mostly", "mainly", "partly", "slightly", "extremely", "quite",
       "really", "almost", "too", "also", "not"}
# caption-domain adjectives that suffix rules miss
_JJ = {"black", "white", "red", "blue", "green", "yellow", "brown", "grey",
       "gray", "orange", "purple", "pink", "tan", "golden", "dark", "light",
       "pale", "bright", "vivid", "dull", "small", "large", "big", "little",
       "long", "short", "thin", "thick", "sharp", "blunt", "wide", "narrow",
       "flat", "round", "smooth", "fluffy", "downy", "iridescent", "vibrant",
       "crested", "speckled", "spotted", "striped", "mottled", "barred",
       "hooked", "curved", "stubby", "sleek", "plump", "slender", "medium",
       "tiny", "huge", "giant", "colorful", "beautiful", "distinct", "wild",
       "open", "empty", "full", "fresh", "old", "young", "new", "clear",
       "cloudy", "sunny", "busy", "crowded", "wooden", "plastic", "metal",
       "glass", "stone", "brick"}


def _suffix_tag(w: str) -> Optional[str]:
    if w.endswith("ing"):
        return "VBG"
    if w.endswith("ed"):
        return "VBD"
    if w.endswith(("ish", "ous", "ful", "less", "able", "ible", "al", "ive",
                   "ic", "y")):
        return "JJ"
    if w.endswith("ly"):
        return "RB"
    if w.endswith("est"):
        return "JJS"
    if w.endswith("er") and len(w) > 4:
        return "JJR"
    return None


class LexiconTagger:
    """Offline Penn-style tagger for caption text (no downloads)."""

    def tag(self, tokens: Sequence[str]) -> List[Tuple[str, str]]:
        out: List[Tuple[str, str]] = []
        for w in tokens:
            lw = w.lower()
            if lw in _DT:
                tag = "DT"
            elif lw == "that":
                # relative pronoun between noun and verb; approximated as WDT
                tag = "WDT"
            elif lw in _CC:
                tag = "CC"
            elif lw in _IN:
                tag = "IN"
            elif lw in _PRP:
                tag = "PRP$" if lw in {"its", "his", "her", "their", "our",
                                       "my", "your"} else "PRP"
            elif lw in _WP:
                tag = "WP"
            elif lw in _CD or lw.isdigit():
                tag = "CD"
            elif lw in _BE_VBZ:
                tag = "VBZ"
            elif lw in _BE_VBP:
                tag = "VBP"
            elif lw in _VB:
                tag = "VB"
            elif lw in _RB:
                tag = "RB"
            elif lw in _JJ:
                tag = "JJ"
            else:
                tag = _suffix_tag(lw) or ("NNS" if lw.endswith("s") and
                                          not lw.endswith("ss") else "NN")
            out.append((w, tag))
        return out


def make_tagger(mode: str = "lexicon", stanford_model: str = "",
                stanford_jar: str = ""):
    if mode == "stanford" and stanford_model and stanford_jar:
        from nltk.tag import StanfordPOSTagger

        return StanfordPOSTagger(stanford_model, stanford_jar)
    if mode == "perceptron":
        from nltk.tag import PerceptronTagger

        try:
            return PerceptronTagger()
        except LookupError:
            print("PerceptronTagger data unavailable — falling back to the "
                  "lexicon tagger")
    return LexiconTagger()


# ---------------------------------------------------------------------------
# Regex chunker (the semantics of nltk.RegexpParser for single-rule stages)
# ---------------------------------------------------------------------------

# A tag pattern's '.' matches one character of a tag, never a delimiter.
_TAG_CHAR = r"[^\{\}<>]"
# Zero-width: the position is outside every chunk made so far.
_IN_STRIP = r"(?=[^\}]*(\{|$))"


class Chunk:
    """A labelled group of tagged tokens and nested chunks."""

    def __init__(self, label: str, children: List["Piece"]):
        self.label = label
        self.children = children

    def leaves(self) -> List[Tuple[str, str]]:
        out: List[Tuple[str, str]] = []
        for c in self.children:
            out.extend(c.leaves() if isinstance(c, Chunk) else [c])
        return out

    def subtrees(self):
        """This chunk and every chunk inside it, outermost first."""
        yield self
        for c in self.children:
            if isinstance(c, Chunk):
                yield from c.subtrees()


Piece = Union[Tuple[str, str], Chunk]


def _tag_pattern_to_regex(pattern: str) -> str:
    """``<NN.*>+`` -> a regex over the ``<tag><tag>...`` string: angle
    brackets group like parentheses, whitespace is dropped and an unescaped
    '.' matches one tag character."""
    p = re.sub(r"\s", "", pattern)
    p = p.replace("<", "(<(").replace(">", ")>)")
    return re.sub(r"(?<!\\)\.", lambda _: _TAG_CHAR, p)


class RegexpChunker:
    """Cascaded regex chunker over POS-tagged tokens.

    ``grammar`` holds one ``LABEL: {tag pattern}`` rule per line; each line
    is one stage, applied in order. A stage turns every leftmost,
    non-overlapping run of top-level pieces whose tags match the pattern
    into a chunk named LABEL; later stages see that chunk as the single tag
    LABEL. This is what ``nltk.RegexpParser`` does with such a grammar.
    """

    def __init__(self, grammar: str):
        self.stages: List[Tuple[str, "re.Pattern"]] = []
        for line in grammar.split("\n"):
            line = line.strip()
            if not line:
                continue
            label, sep, rule = line.partition(":")
            rule = rule.strip()
            if not sep or not (rule.startswith("{") and rule.endswith("}")):
                raise ValueError(f"expected 'LABEL: {{pattern}}', got {line!r}")
            regex = re.compile(
                f"(?P<chunk>{_tag_pattern_to_regex(rule[1:-1])}){_IN_STRIP}")
            self.stages.append((label.strip(), regex))

    @staticmethod
    def _tag(piece: Piece) -> str:
        return piece.label if isinstance(piece, Chunk) else piece[1]

    def parse(self, tagged: Sequence[Tuple[str, str]]) -> Chunk:
        pieces: List[Piece] = list(tagged)
        for label, regex in self.stages:
            s = "<" + "><".join(self._tag(p) for p in pieces) + ">"
            s = regex.sub(r"{\g<chunk>}", s).replace("{}", "")
            out: List[Piece] = []
            index = 0
            for k, part in enumerate(re.split("[{}]", s)):
                n = part.count("<")
                run = pieces[index:index + n]
                if k % 2:
                    out.append(Chunk(label, run))
                else:
                    out.extend(run)
                index += n
            pieces = out
        return Chunk("S", pieces)


# ---------------------------------------------------------------------------
# Chunk grammars (behavioural rebuild of prepare_attributes.py:91-206)
# ---------------------------------------------------------------------------

def _bird_flower_grammars(nested_loc_and: bool):
    adj = "<JJ.*|VBD|VBN|VBG>"
    det = "<PDT|DT|PRP.*|POS>"
    pron = "<IN|WP*|WDT>"
    verb = "<VB|VBP|VBZ>"

    adj_noun = (f"AND: {{<CC>{det}?<NN.*>+}}\n"
                f"NP: {{{det}?{adj}+<NN.*>+<AND>*}}")
    coord_adj = (f"AND2: {{<CC>{adj}+}}\n"
                 f"NP: {{{det}?{adj}+<AND2>*<NN.*>+}}")
    copular = (f"INTRO: {{<NN.*>+{pron}?{verb}<IN>?}}\n"
               f"AND2: {{<CC>{adj}+}}\n"
               f"NP: {{<INTRO>{det}?{adj}*<AND2>*<NN.*>*}}")
    if nested_loc_and:  # Oxford variant allows "petals on the stem and leaves"
        location = (f"AND: {{<CC>{det}?<NN.*>+}}\n"
                    f"LOC: {{<IN>{det}?{adj}*<NN.*>+<AND>*}}\n"
                    f"NP: {{<NN.*>+<LOC>+}}")
    else:
        location = (f"LOC: {{<IN>{det}?{adj}*<NN.*>+}}\n"
                    f"NP: {{<NN.*>+<LOC>+}}")
    noun_verb_stub = f"NP: {{<NN.*>+{verb}+{det}*}}"
    return [adj_noun, coord_adj, copular, location], [noun_verb_stub]


def _coco_grammars():
    adj = "<JJ.*|VBD|VBN|VBG|RB>"
    det = "<PDT|DT|PRP.*|CD>"
    pron = "<IN|WP*|WDT>"
    verb = "<VB|VBD|VBG|VBN|VBP|VBZ>"

    counted = (f"RES: {{{pron}{det}?<NN.*>+}}\n"
               f"NP: {{{det}*{adj}*<NN.*>+<RES>?}}")
    verb_phrase = f"NP: {{<NN.*>+{verb}+{pron}*{det}*{adj}*<NN.*>*}}"
    nested_loc = (f"LOC: {{{pron}{det}*{adj}*<NN.*>+{pron}*{det}*{adj}*<NN.*>*}}\n"
                  f"NP: {{<NN.*>+<LOC>}}")
    return [counted, verb_phrase, nested_loc], []


def grammars_for(dataset_name: str):
    if dataset_name == "bird":
        return _bird_flower_grammars(nested_loc_and=False)
    if dataset_name == "flower":
        return _bird_flower_grammars(nested_loc_and=True)
    return _coco_grammars()


class AttributeExtractor:
    def __init__(self, dataset_name: str, tagger_mode: str = "lexicon",
                 stanford_model: str = "", stanford_jar: str = ""):
        self.dataset_name = dataset_name
        self.tagger = make_tagger(tagger_mode, stanford_model, stanford_jar)
        keep, subtract = grammars_for(dataset_name)
        self.parsers = [RegexpChunker(g) for g in keep]
        self.subtract_parsers = [RegexpChunker(g) for g in subtract]

    @staticmethod
    def _phrases(parser: RegexpChunker, tags) -> List[str]:
        return [" ".join(tok for tok, _ in sub.leaves())
                for sub in parser.parse(tags).subtrees() if sub.label == "NP"]

    def parse_caption(self, tokens_or_text) -> List[List[str]]:
        """Tokens (or raw text) -> sorted list of attribute word-lists
        (reference `do_parse_one_caption`, prepare_attributes.py:213-251)."""
        if isinstance(tokens_or_text, str):
            from eegan_tpu_torch.data.prep import tokenize_caption

            tokens = tokenize_caption(tokens_or_text)
        else:
            tokens = list(tokens_or_text)
        if not tokens:
            return []
        tags = self.tagger.tag(tokens)

        found = set()
        for parser in self.parsers:
            found.update(self._phrases(parser, tags))
        for parser in self.subtract_parsers:
            found.difference_update(self._phrases(parser, tags))
        return [phrase.split(" ") for phrase in sorted(found)]

    def parse_id_caption(self, token_ids: Sequence[int],
                         ixtoword: Dict[int, str],
                         wordtoix: Dict[str, int]) -> List[List[int]]:
        words = [ixtoword[ix] for ix in token_ids]
        attrs = self.parse_caption(words)
        return [[wordtoix[w] for w in attr if w in wordtoix]
                for attr in attrs]


def _pool_worker(args):
    (dataset_name, tagger_mode, chunk, ixtoword, wordtoix) = args
    extractor = AttributeExtractor(dataset_name, tagger_mode)
    return [extractor.parse_id_caption(c, ixtoword, wordtoix) for c in chunk]


def extract_all(captions: Sequence[Sequence[int]], ixtoword, wordtoix,
                dataset_name: str, tagger_mode: str = "lexicon",
                workers: int = 16, chunk_size: int = 50) -> List:
    """Multiprocess extraction over all captions (reference
    `multi_thread_processing`, prepare_attributes.py:276-311)."""
    chunks = [captions[i:i + chunk_size]
              for i in range(0, len(captions), chunk_size)]
    args = [(dataset_name, tagger_mode, c, ixtoword, wordtoix) for c in chunks]
    if workers <= 1 or len(chunks) <= 1:
        results = [_pool_worker(a) for a in args]
    else:
        # spawn: a forked child of a process with threads (CUDA's, the
        # BLAS pools) may inherit a held lock.
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            results = pool.map(_pool_worker, args)
    out: List = []
    for r in results:
        out.extend(r)
    return out


def build_attributes_pickle(data_dir: str, dataset_name: str,
                            attr_name: str = "EE-GAN",
                            tagger_mode: str = "lexicon",
                            workers: int = 16) -> str:
    """Full artefact build: captions.pickle -> attributes/<name>.pickle."""
    from eegan_tpu_torch.data.datasets import load_captions_pickle

    train_caps, test_caps, ixtoword, wordtoix, _ = load_captions_pickle(data_dir)
    train_attrs = extract_all(train_caps, ixtoword, wordtoix, dataset_name,
                              tagger_mode, workers)
    test_attrs = extract_all(test_caps, ixtoword, wordtoix, dataset_name,
                             tagger_mode, workers)
    out_dir = os.path.join(data_dir, "attributes")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{attr_name}.pickle")
    with open(out_path, "wb") as f:
        pickle.dump([train_attrs, test_attrs], f, protocol=2)
    print("Save to:", out_path)
    return out_path
