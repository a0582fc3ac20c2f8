"""Variant model tests (parity values from ref: src/data_types/variants.rs tests)."""

import pytest

from hiphase_jax.core import AlleleType, Variant, VariantError, VariantType
from hiphase_jax.core.variants import UNDETERMINED_ALLELE


def test_basic_snv():
    v = Variant.new_snv(0, 1, b"A", b"C", 0, 1)
    assert v.variant_type == VariantType.SNV
    assert v.position == 1
    assert v.ref_len == 1
    assert v.match_allele(b"A") == 0
    assert v.match_allele(b"C") == 1
    assert v.match_allele(b"G") == 2
    assert v.match_allele(b"T") == 2
    assert v.convert_index(AlleleType.REFERENCE) == 0
    assert v.convert_index(AlleleType.ALTERNATE) == 1
    assert v.convert_index(AlleleType.AMBIGUOUS) == UNDETERMINED_ALLELE


def test_basic_deletion():
    v = Variant.new_deletion(0, 10, 3, b"AGT", b"A", 0, 1)
    assert v.variant_type == VariantType.DELETION
    assert v.ref_len == 3
    assert v.match_allele(b"AGT") == 0
    assert v.match_allele(b"A") == 1
    assert v.match_allele(b"AG") == 2

    # multi-allelic deletion: ALTs must still be length 1
    v = Variant.new_deletion(0, 10, 4, b"C", b"A", 1, 2)
    assert v.match_allele(b"ACCC") == 2
    assert v.match_allele(b"C") == 0
    assert v.match_allele(b"A") == 1
    assert v.convert_index(AlleleType.REFERENCE) == 1
    assert v.convert_index(AlleleType.ALTERNATE) == 2


def test_basic_insertion():
    v = Variant.new_insertion(0, 20, b"A", b"AGT", 0, 1)
    assert v.variant_type == VariantType.INSERTION
    assert v.ref_len == 1
    assert v.match_allele(b"A") == 0
    assert v.match_allele(b"AGT") == 1
    assert v.match_allele(b"AG") == 2


def test_basic_indel():
    v = Variant.new_indel(0, 20, 2, b"A", b"AGT", 1, 2)
    assert v.variant_type == VariantType.INDEL
    assert v.ref_len == 2
    assert v.match_allele(b"A") == 0
    assert v.match_allele(b"AGT") == 1


def test_sv_constructors():
    v = Variant.new_sv_insertion(0, 20, 1, b"A", b"AGT", 0, 1)
    assert v.variant_type == VariantType.SV_INSERTION
    v = Variant.new_sv_deletion(0, 10, 3, b"AGT", b"A", 0, 1)
    assert v.variant_type == VariantType.SV_DELETION
    with pytest.raises(VariantError):
        Variant.new_sv_deletion(0, 10, 3, b"AGT", b"A", 1, 2)
    with pytest.raises(VariantError):
        Variant.new_sv_insertion(0, 20, 1, b"A", b"AGT", 0, 2)
    with pytest.raises(VariantError):
        Variant.new_sv_deletion(0, 10, 1, b"A", b"AGT", 0, 1)


def test_tandem_repeat():
    v = Variant.new_tandem_repeat(0, 10, 4, b"AAAC", b"AAACAAAC", 0, 1)
    assert v.variant_type == VariantType.TANDEM_REPEAT
    assert v.match_allele(b"AAAC") == 0
    assert v.match_allele(b"AAACAAAC") == 1
    assert v.match_allele(b"AAACAA") == 2


def test_reference_adjustment():
    # models AG -> A / AGT (parity with ref: variants.rs:800-846)
    v = Variant.new_indel(0, 20, 2, b"A", b"AGT", 1, 2)
    assert v.prefix_len == 0 and v.postfix_len == 0

    v.add_reference_prefix(b"AC")
    v.add_reference_postfix(b"GGCC")
    assert v.get_truncated_allele0() == b"A"
    assert v.get_truncated_allele1() == b"AGT"

    v.truncate_reference_postfix(1)
    assert v.prefix_len == 2
    assert v.postfix_len == 3

    assert v.match_allele(b"A") == 2
    assert v.match_allele(b"AGT") == 2

    assert v.closest_allele(b"A") == (AlleleType.REFERENCE, 5, 7)
    assert v.closest_allele(b"AGT") == (AlleleType.REFERENCE, 4, 5)
    assert v.closest_allele(b"AG") == (AlleleType.REFERENCE, 4, 6)

    assert v.closest_allele(b"ACAGGC") == (AlleleType.REFERENCE, 0, 2)
    assert v.closest_allele(b"ACAGTGGC") == (AlleleType.ALTERNATE, 0, 2)
    assert v.closest_allele(b"ACAGGGC") == (AlleleType.AMBIGUOUS, 1, 1)


def test_invalid_constructors():
    with pytest.raises(VariantError):
        Variant.new_snv(0, 1, b"AA", b"C", 0, 1)
    with pytest.raises(VariantError):
        Variant.new_snv(0, 1, b"A", b"C", 1, 1)
    with pytest.raises(VariantError):
        Variant.new_deletion(0, 10, 1, b"A", b"C", 0, 1)
