"""The SVC member's coupling loop (``models/svm._binary_coupling``) under its
two drivers: unrolled (the eager and captured route) and as one ``scan``
(``svm.coupling_as_scan``, the form ``persist/aot`` traces). Both run the
same step, so they must agree bit for bit, eagerly and through
``torch.export``'s program, in float64 and float32, on lanes that meet the
tolerance at different iterations (the ``done`` mask), lanes that never do,
and ``r0`` at the clip bounds; and the unrolled driver still equals the JAX
package's loop.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_replications_tpu.models import svm as jsvm
from machine_learning_replications_tpu_torch.models import svm

_MIN = 1e-7


def _lanes(dtype) -> torch.Tensor:
    """259 pairwise probabilities: a sweep of (0, 1), both clip bounds and
    their neighbours, and 0.5 (converged at the first step)."""
    r0 = np.concatenate([
        np.linspace(0.0, 1.0, 251),
        [_MIN, 1 - _MIN, 2 * _MIN, 1 - 2 * _MIN, 0.5, 0.25, 0.75, 1e-3],
    ])
    return torch.as_tensor(np.clip(r0, _MIN, 1 - _MIN)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_scan_driver_equals_unrolled_bit_for_bit(dtype):
    r0 = _lanes(dtype)
    unrolled = svm._binary_coupling(r0)
    with svm.coupling_as_scan():
        scanned = svm._binary_coupling(r0)
    assert scanned.dtype == dtype and torch.equal(scanned, unrolled)
    # the switch is scoped: outside the block the loop is unrolled again
    assert not svm._DRIVER.scan

    class _Coupling(torch.nn.Module):
        def forward(self, r):
            return svm._binary_coupling(r)

    with torch.no_grad(), svm.coupling_as_scan():
        ep = torch.export.export(_Coupling(), (r0[:8],), dynamic_shapes=(
            {0: torch.export.Dim("batch", min=1, max=512)},))
    assert any("scan" in str(n.target) for n in ep.graph.nodes)
    assert torch.equal(ep.module()(r0), unrolled)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-15), (torch.float32, 1e-6)])
def test_unrolled_driver_equals_jax_loop(dtype, tol):
    """The refactor into one step keeps the JAX package's trajectory."""
    r0 = _lanes(dtype)
    want = np.asarray(jsvm._binary_coupling(jnp.asarray(r0.numpy())))
    np.testing.assert_allclose(svm._binary_coupling(r0).numpy(), want, rtol=tol, atol=tol)
