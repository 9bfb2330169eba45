"""The MoE and early-fusion families against the JAX package: the MoE +
MLA deepseek-v2-lite-16b and the early-fusion phi-3-vision-4.2b and
llama4-scout-17b-a16e (``test_torch_archs.THERE``), through the same
tests as ``test_torch_archs.py`` runs on the recurrent and dense configs
and whisper-tiny; see its docstring for what each holds."""
import pytest
import torch

import test_torch_archs as archs
from test_torch_archs import MOE, THERE, _id, _stream_cases


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("arch", THERE, ids=_id)
def test_port_init_matches_reference_tree(arch):
    archs.test_port_init_matches_reference_tree(arch)


@pytest.mark.parametrize("arch", THERE, ids=_id)
def test_forward_logits_match_reference(arch):
    archs.test_forward_logits_match_reference(arch)


@pytest.mark.parametrize("arch", THERE, ids=_id)
def test_prefill_decode_matches_forward(arch):
    archs.test_prefill_decode_matches_forward(arch)


@pytest.mark.parametrize("arch,backend", _stream_cases(THERE),
                         ids=lambda v: v if isinstance(v, str) else _id(v))
def test_greedy_streams_equal_reference(arch, backend):
    archs.test_greedy_streams_equal_reference(arch, backend)


@pytest.mark.parametrize("arch", MOE, ids=_id)
def test_program_tags_and_trace_match_reference(arch):
    archs.test_program_tags_and_trace_match_reference(arch)


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b",
                                  "llama4-scout-17b-a16e"])
def test_grouped_training_on_bpbs_matches_reference(name):
    archs.test_grouped_training_on_bpbs_matches_reference(name)
