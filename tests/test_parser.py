"""Parser + Glushkov builder unit tests."""
import pytest

from roaringregex.compiler.nfa import build_nfa, count_positions
from roaringregex.compiler.parser import (
    BOS,
    EOS,
    Alt,
    Concat,
    Empty,
    Lit,
    RegexSyntaxError,
    Repeat,
    parse,
)


def test_precedence_closure_over_concat_over_alt():
    ast = parse("ab|cd*")
    assert isinstance(ast, Alt)
    left, right = ast.parts
    assert isinstance(left, Concat) and len(left.parts) == 2
    assert isinstance(right, Concat)
    assert isinstance(right.parts[1], Repeat)  # d* binds tighter than concat


def test_escape_is_literal():
    ast = parse("a\\.b")
    assert isinstance(ast, Concat)
    assert ast.parts[1] == Lit(frozenset({ord(".")}))


def test_anchors_are_virtual_symbols():
    assert parse("^") == Lit(frozenset({BOS}))
    assert parse("$") == Lit(frozenset({EOS}))


def test_bracket_ranges_and_negation():
    lit = parse("[a-cx]")
    assert lit.syms == frozenset({ord("a"), ord("b"), ord("c"), ord("x")})
    neg = parse("[^a-c]")
    assert ord("d") in neg.syms and ord("a") not in neg.syms
    assert len(neg.syms) == 125
    # '-' literal at edges
    assert ord("-") in parse("[-a]").syms
    assert ord("-") in parse("[a-]").syms


def test_dot_is_all_ascii():
    assert parse(".").syms == frozenset(range(128))


def test_braces_forms():
    assert parse("a{3}") == Repeat(Lit(frozenset({ord("a")})), 3, 3)
    assert parse("a{2,}") == Repeat(Lit(frozenset({ord("a")})), 2, None)
    assert parse("a{2,5}") == Repeat(Lit(frozenset({ord("a")})), 2, 5)


def test_empty_pattern_and_group():
    assert parse("") == Empty()
    assert parse("()") == Empty()
    with pytest.raises(RegexSyntaxError):
        parse("(|a)")  # empty alternation branch is rejected everywhere


# ---- sizing pass (the PseudoNFA analog) ----


@pytest.mark.parametrize(
    "pattern,positions",
    [
        ("abc", 3),
        ("(ab)*c+d?", 4),
        ("a{1,300}", 300),
        ("a{3,}", 3),
        ("(ab|cd){2}", 8),
        ("", 0),
        (".", 1),
        ("^abc$", 5),
    ],
)
def test_count_positions(pattern, positions):
    assert count_positions(parse(pattern)) == positions


def test_state_ids_not_truncated():
    # Reference defect SS2.12.1: ids truncated to uint8. We must be exact
    # far past 256 states.
    nfa = build_nfa("a{1,300}")
    assert nfa.n_states == 301
    # the chain structure must be intact at the high end
    assert 300 in nfa.get_follow_sets()[299]
    assert 300 in nfa.accept_set
    assert 1 in nfa.accept_set  # a{1,..}: every prefix >= 1 accepts


def test_follow_factorization_shapes():
    nfa = build_nfa("(cat|dog)+")
    F = nfa.follow_matrix
    B = nfa.symtab
    assert F.shape == (7, 7)
    assert B.shape == (130, 7)
    # every transition target enters only on its own label: column p of B
    # is nonzero exactly on label(p)
    for p, syms in enumerate(nfa.labels, start=1):
        assert set(B[:, p].nonzero()[0]) == set(syms)


def test_dump_smoke():
    out = build_nfa("a(b|c)*$").dump()
    assert "states:" in out and "follow=" in out
