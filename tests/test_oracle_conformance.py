"""Conformance corpus: the oracle must reproduce the reference's verified
behavior (SURVEY.md SS4.3) plus the documented fixes (working anchors,
defined {0,n}), and agree with Python ``re`` on the shared subset."""
import random
import re

import pytest

from roaringregex.compiler.parser import RegexSyntaxError
from roaringregex.oracle.engine import OracleEngine

# (text, pattern, accept?) -- transcribed from SURVEY.md SS4.3, every row of
# which was verified against the reference binary.
REFERENCE_VERIFIED = [
    # literal / concat
    ("abc", "abc", True),
    ("xabc", "abc", False),
    ("abcx", "abc", False),
    # alternation + precedence (Parser.cpp clear_stack reduction)
    ("ab", "ab|cd", True),
    ("cd", "ab|cd", True),
    ("abcd", "ab|cd", False),
    ("ad", "ab|cd", False),
    # groups
    ("a", "(a)", True),
    ("ac", "(a|b)(c|d)", True),
    ("bd", "(a|b)(c|d)", True),
    ("ab", "(a|b)(c|d)", False),
    # star
    ("aaa", "a*", True),
    ("", "a*", True),
    ("b", "a*", False),
    ("abab", "(ab)*", True),
    ("aba", "(ab)*", False),
    ("ba", "(a|b)*", True),
    # plus
    ("ab", "a+b", True),
    ("aaab", "a+b", True),
    ("b", "a+b", False),
    # optional
    ("ab", "ab?", True),
    ("a", "ab?", True),
    ("", "a?", True),
    ("", "a", False),
    # bounded repetition
    ("aa", "a{2}", True),
    ("aaa", "a{2,4}", True),
    ("a", "a{2,4}", False),
    ("aaaaa", "a{2,4}", False),
    ("aaa", "a{2,}", True),
    ("a", "a{2,}", False),
    # wildcard
    ("xyz", "...", True),
    ("abc", "a.c", True),
    # brackets
    ("b", "[a-c]", True),
    ("d", "[a-c]", False),
    ("d", "[^a-c]", True),
    ("]", "[\\]]", True),
    # escapes
    ("a.b", "a\\.b", True),
    ("axb", "a\\.b", False),
    # nested (BASELINE config 3)
    ("ababccd", "(ab)*c+d?", True),
    ("c", "(ab)*c+d?", True),
    ("abd", "(ab)*c+d?", False),
]

# Anchors: the reference *declares* these (README.md:41) but ships NUL-literal
# placeholders that never match (defect SS2.12.4). We implement them correctly:
# in whole-string acceptance, edge anchors are tautological.
ANCHORS_FIXED = [
    ("abc", "^abc$", True),
    ("abc", "abc$", True),
    ("abc", "^abc", True),
    ("abc", "^abd$", False),
    ("", "^$", True),
    ("a", "^$", False),
    ("abc", "^a.c$", True),
    # interior anchors are unsatisfiable mid-string (assertion semantics)
    ("ab", "a^b", False),
    ("ab", "a$b", False),
    # anchors inside groups at valid boundary positions work
    ("bc", "(a|^b)c", True),
    ("ac", "(a|^b)c", True),
]

# {0,n} defined (reference behavior accidental, SS2.12.6)
BOUNDED_ZERO = [
    ("", "a{0,2}", True),
    ("a", "a{0,2}", True),
    ("aa", "a{0,2}", True),
    ("aaa", "a{0,2}", False),
    ("", "a{0}", True),
    ("a", "a{0}", False),
    ("b", "a{0,}b", True),
]

# tier-crossing self-matches (SS4.3 tiers 2-4); the reference crashes or is
# statically broken above 128 states -- we must not be.
TIER_CASES = [
    ("a" * 40, "a" * 40, True),  # ~81 states: vector tier
    ("a" * 70, "a" * 70, True),  # ~141 states: vector tier
    ("a" * 69, "a" * 70, False),
    ("a" * 300, "a{1,300}", True),  # ~301 states: block-sparse tier
    ("a" * 301, "a{1,300}", False),
    ("a", "a{1,300}", True),
    ("", "a{1,300}", False),
]


@pytest.mark.parametrize(
    "text,pattern,expect",
    REFERENCE_VERIFIED + ANCHORS_FIXED + BOUNDED_ZERO + TIER_CASES,
)
def test_fullmatch_corpus(text, pattern, expect):
    eng = OracleEngine.compile(pattern)
    assert eng.fullmatch(text) is expect


@pytest.mark.parametrize(
    "pattern",
    ["[abc", "a|", "|a", "*a", "+", "?", "a)", "(a", "a{2,1}", "a{x}", "[]"],
)
def test_invalid_patterns_raise(pattern):
    with pytest.raises(RegexSyntaxError):
        OracleEngine.compile(pattern)


def test_trailing_alternation_empty_branch():
    # POSIX rejects trailing '|' (reference crashes); we raise.
    with pytest.raises(RegexSyntaxError):
        OracleEngine.compile("ab|")


# ---------------------------------------------------------------------------
# Span semantics (lazy finditer -- normative policy, see oracle docstring)
# ---------------------------------------------------------------------------


def test_finditer_literal():
    eng = OracleEngine.compile("ab")
    assert eng.findall("xxabyyabz") == [(2, 4), (6, 8)]


def test_finditer_lazy_shortest():
    eng = OracleEngine.compile("a+")
    # lazy: shortest match at each leftmost start, non-overlapping
    assert eng.findall("aaab") == [(0, 1), (1, 2), (2, 3)]


def test_finditer_alternation_leftmost():
    eng = OracleEngine.compile("a|ba")
    # leftmost start wins: 'ba' starts at 0
    assert eng.findall("ba") == [(0, 2)]


def test_finditer_empty_matches_advance():
    # lazy semantics: a nullable pattern's shortest match is always empty
    # (same spans Python re gives for the non-greedy 'a*?')
    # (Python's re additionally retries a non-empty match at the same
    # position after an empty one -- 'a*?' on 'ba' also yields (1,2). Our
    # normative policy simply advances by one; both are self-consistent.)
    eng = OracleEngine.compile("a*")
    assert eng.findall("ba") == [(0, 0), (1, 1), (2, 2)]


def test_finditer_anchored():
    eng = OracleEngine.compile("^ab")
    assert eng.findall("abab") == [(0, 2)]
    eng = OracleEngine.compile("ab$")
    assert eng.findall("abab") == [(2, 4)]


def test_search_and_ends():
    eng = OracleEngine.compile("cat|dog")
    assert eng.search("the dog barks")
    assert not eng.search("the cow moos")
    assert eng.ends("catdog") == {3, 6}
    assert eng.starts("catdog") == {0, 3}


def test_ends_with_eos_anchor():
    eng = OracleEngine.compile("g$")
    assert eng.ends("dog") == {3}
    assert eng.ends("dogs") == set()


# ---------------------------------------------------------------------------
# Differential fuzz vs Python re (shared-subset semantics: fullmatch)
# ---------------------------------------------------------------------------

_LIT = list("abc")


def _gen_pattern(rng: random.Random, depth: int = 0) -> str:
    r = rng.random()
    if depth >= 3 or r < 0.3:
        return rng.choice(_LIT + [".", "[ab]", "[^a]", "[a-c]"])
    if r < 0.5:
        return _gen_pattern(rng, depth + 1) + _gen_pattern(rng, depth + 1)
    if r < 0.65:
        return "(" + _gen_pattern(rng, depth + 1) + "|" + _gen_pattern(rng, depth + 1) + ")"
    if r < 0.75:
        return "(" + _gen_pattern(rng, depth + 1) + ")*"
    if r < 0.85:
        return "(" + _gen_pattern(rng, depth + 1) + ")+"
    if r < 0.92:
        return "(" + _gen_pattern(rng, depth + 1) + ")?"
    m = rng.randint(0, 2)
    n = rng.randint(m, m + 2)
    return "(" + _gen_pattern(rng, depth + 1) + ")" + f"{{{m},{n}}}"


def test_fuzz_fullmatch_vs_re():
    rng = random.Random(20260816)
    checked = 0
    for _ in range(300):
        pat = _gen_pattern(rng)
        try:
            eng = OracleEngine.compile(pat)
        except Exception as exc:  # pragma: no cover
            raise AssertionError(f"compile failed for {pat!r}: {exc}")
        cre = re.compile(pat)
        for _ in range(20):
            n = rng.randint(0, 6)
            text = "".join(rng.choice("abcd") for _ in range(n))
            got = eng.fullmatch(text)
            want = cre.fullmatch(text) is not None
            assert got is want, f"pattern={pat!r} text={text!r} got={got} want={want}"
            checked += 1
    assert checked == 6000


def test_fuzz_finditer_count_vs_re_nonempty():
    """For patterns that cannot match empty, lazy finditer finds a match
    inside every region where re finds one (weaker check; exact spans differ
    because re is greedy)."""
    rng = random.Random(7)
    for _ in range(100):
        pat = rng.choice(["ab", "a+", "ca(t|b)", "[ab]c", "a.c", "ab|ba"])
        eng = OracleEngine.compile(pat)
        cre = re.compile(pat)
        n = rng.randint(0, 12)
        text = "".join(rng.choice("abct") for _ in range(n))
        ours = eng.findall(text)
        theirs = [m.span() for m in cre.finditer(text)]
        # same number of leftmost starts is not guaranteed under laziness,
        # but existence must agree:
        assert bool(ours) == bool(theirs), (pat, text, ours, theirs)
        if ours and theirs:
            assert ours[0][0] == theirs[0][0], (pat, text, ours, theirs)
