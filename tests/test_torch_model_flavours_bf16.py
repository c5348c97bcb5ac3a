"""The bfloat16 cases of ``test_torch_model_flavours.py`` (whose
docstring states the tolerances): each dense flavour and the VLM family
on the reduced qwen3-1.7b config against the JAX package, with the
checks of ``flavour_cases.py`` (MLA's bf16 cases are in
``test_torch_model_mla.py``)."""
import pytest

from flavour_cases import (GQA_FLAVOURS, check_apply,
                           check_paged_kernel_paths,
                           check_prefill_then_decode,
                           check_weights_and_parameter_counts, make_pair)


@pytest.fixture(scope="module", params=GQA_FLAVOURS)
def pair(request):
    return make_pair(request.param, "bfloat16")


def test_weights_and_parameter_counts_match(pair):
    check_weights_and_parameter_counts(pair)


def test_apply_matches(pair):
    check_apply(pair)


def test_prefill_then_decode_match(pair):
    check_prefill_then_decode(pair)


def test_paged_kernel_paths_match_or_refuse_mla(pair):
    check_paged_kernel_paths(pair)
