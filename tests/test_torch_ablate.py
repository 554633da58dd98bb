"""The ablations' patches (``qasr_torch/tools/ablate_qgemm.py``,
``ablate_qconv.py``, ``ablate_scan.py``, ``ablate_dgt.py``) still apply to the kernels'
sources: every version's edits find their lines in ``csrc`` and change
them. (Building and timing the versions needs the card.)"""

import pytest

from qasr_torch.tools import _ablate, ablate_dgt, ablate_qconv, ablate_qgemm, ablate_scan

CASES = [(tool, name) for tool in (ablate_qgemm, ablate_qconv, ablate_scan, ablate_dgt)
         for name in tool.VERSIONS]


@pytest.mark.parametrize("tool,name", CASES,
                         ids=[f"{t.__name__.rsplit('.', 1)[1]}-{n.split(' (')[0]}"
                              for t, n in CASES])
def test_ablation_edits_apply(tool, name):
    edits, _ = tool.VERSIONS[name]
    texts = _ablate.patched(tool.SOURCES, edits)
    plain = _ablate.patched(tool.SOURCES, [])
    assert set(texts) >= set(tool.SOURCES)
    changed = {f for f in texts if texts[f] != plain[f]}
    assert changed == {f for f, _, _ in edits}
