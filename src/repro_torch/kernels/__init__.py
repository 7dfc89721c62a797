"""Hand-written CUDA kernels of the port, each beside its plain version.

  fused_sample             Algorithm 1 for one level
                           (``csrc/fused_sample.cu``)
  sage_aggregate           masked neighbour mean, forward
                           (``csrc/sage_aggregate.cu``)
  sage_backward_index      the transpose the gradient gathers over
                           (``csrc/sage_backward_index.cu``)
  sage_aggregate_backward  its gradient (``csrc/sage_aggregate.cu``)
  feature_gather           owner-side feature-row gather
                           (``csrc/feature_gather.cu``)
  gather_rows              pinned hot-row gather (``csrc/gather_rows.cu``)
  sage_epilogue            a sage hidden layer's tail: sum, bias, relu,
                           dropout (``csrc/sage_epilogue.cu``)
  sage_epilogue_backward   its gradient and the bias's
                           (``csrc/sage_epilogue.cu``)
  gat_attention            a gatv1 layer's attention over rows of its
                           projected table: scores, softmax over the
                           sampled edges and the self loop, weighted sum
                           (``csrc/gat_attention.cu``)
  gat_attention_backward   its gradients, the table's over the transpose
                           ``sage_backward_index`` builds
                           (``csrc/gat_attention.cu``)

Each wrapper counts its launches in a ``launches`` attribute.  The
single-pass scan that ``fused_sample`` and ``sage_backward_index`` share is
``csrc/scan.cuh`` (its scratch: ``scan``).  Sources are
compiled by ``nvcc`` at first use on a CUDA tensor (``_build``).  This
package imports its modules lazily: the core modules import single kernel
modules, and the fused sampler's plain version imports the core sampler.
"""


def kernel_wrappers() -> tuple:
    """The ten kernel wrappers, in path order."""
    from repro_torch.kernels.feature_gather import feature_gather
    from repro_torch.kernels.fused_sample import fused_sample
    from repro_torch.kernels.gat_attention import (gat_attention,
                                                   gat_attention_backward)
    from repro_torch.kernels.gather import gather_rows
    from repro_torch.kernels.sage_aggregate import (sage_aggregate,
                                                    sage_aggregate_backward,
                                                    sage_backward_index)
    from repro_torch.kernels.sage_epilogue import (sage_epilogue,
                                                   sage_epilogue_backward)
    return (fused_sample, gather_rows, feature_gather, sage_aggregate,
            sage_epilogue, sage_epilogue_backward, gat_attention,
            gat_attention_backward, sage_backward_index,
            sage_aggregate_backward)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for k in kernel_wrappers():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    """{kernel name: launches since the last reset}."""
    return {k.__name__: k.launches for k in kernel_wrappers()}
