"""The int8 tree of yolov7-w6 deploy (ReOrg, DownC, the four-level head)
against the JAX package on the CPU: the zoo tests of
tests/test_torch_port_int8_zoo.py (`calibrate`'s paths and scales,
`quantize_model` full and mixed, `pallas_1x1_eligible` conv by conv, each
int8 layer fed JAX's int8 input), collected here with w6 as `zoo_model`."""

import pytest

from tests.test_torch_port_int8_zoo import (  # noqa: F401  collected here on w6
    make_zoo_model, test_zoo_calibrate_matches_jax,
    test_zoo_eligible_convs_match_jax_full_width, test_zoo_int8_layers_match_jax,
    test_zoo_quantize_matches_jax)


@pytest.fixture(scope="module", params=["w6"])
def zoo_model(request):
    return make_zoo_model(request.param)
