"""host red-team fixture: the wrapper of ``fixture_scale_bias`` written
the way ``bad_host_ast.py``'s kernel body is, pulling ``scale`` and
``bias`` to the host before the launch.  The analyzer's host pass PARSES
this file (``--fixture bad_host``); it is never imported or run."""
# flake8: noqa
import numpy as np
import torch


def scale_bias(x, scale_t):
    """Seeded violations: ``.item()`` and ``np.asarray`` in a kernel
    wrapper (HOST_PULL_IN_WRAPPER): each waits for the card and copies
    to the host before the launch."""
    scale = scale_t.item()                  # device -> host read
    bias = np.asarray(x.cpu()).sum()        # host copy of the rows
    out = torch.empty_like(x)
    _lib().analysis_scale_bias_host(x.data_ptr(), float(scale),
                                    float(bias), out.data_ptr(), x.numel())
    scale_bias.launches += 1
    return out
