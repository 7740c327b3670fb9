"""How far the port's text encoder lies from the JAX package's in bf16.

JAX's ``TextEncoder`` computes in COMPUTE_DTYPE (bf16 ``h``/``c`` carries
under the shipped configs); the port's runs in float32, as the reference's
PyTorch ``RNN_ENCODER``. From the same converted weights and captions at
the configs' widths (300 inputs, 256 hidden), three encoders are compared:
the port's, JAX's at bfloat16, and JAX's at float32, the yardstick. The
port must lie no farther than twice the yardstick from JAX's bf16 encoder,
by relative L2 over the words and over the sentence codes; otherwise it
would have to compute in COMPUTE_DTYPE as JAX's does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegan_tpu.models.text_encoder import TextEncoder as JaxTextEncoder
from eegan_tpu_torch.models.text_encoder import TextEncoder
from eegan_tpu_torch.utils.convert import from_jax_text_encoder

torch.set_num_threads(1)

B, T, NIN, NHID, NTOKEN = 16, 20, 300, 256, 200


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
def test_port_within_twice_jax_float32_of_jax_bf16(rnn_type):
    rng = np.random.RandomState(3)
    lens = rng.randint(1, T + 1, B).astype(np.int32)
    lens[:2] = (1, T)
    caps = rng.randint(1, NTOKEN, (B, T)).astype(np.int32)
    caps = caps * (np.arange(T)[None] < lens[:, None])

    outs = {}
    variables = None
    for name, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        jenc = JaxTextEncoder(ntoken=NTOKEN, ninput=NIN, nhidden=NHID,
                              rnn_type=rnn_type, dtype=dt)
        if variables is None:
            variables = jenc.init(jax.random.PRNGKey(7), jnp.asarray(caps),
                                  jnp.asarray(lens))
        outs[name] = [np.asarray(o) for o in
                      jenc.apply(variables, jnp.asarray(caps),
                                 jnp.asarray(lens))]

    enc = TextEncoder(NTOKEN, ninput=NIN, nhidden=NHID, rnn_type=rnn_type)
    enc.load_state_dict(from_jax_text_encoder(
        jax.tree_util.tree_map(np.asarray, variables)))
    enc.eval()
    with torch.no_grad():
        port = [o.numpy() for o in enc(torch.from_numpy(caps),
                                       torch.from_numpy(lens))]

    for k, what in enumerate(("words", "sent")):
        yardstick = _rel(outs["float32"][k], outs["bfloat16"][k])
        port_gap = _rel(port[k], outs["bfloat16"][k])
        print(f"{rnn_type} {what}: port to JAX bf16 {port_gap:.3e}, "
              f"JAX float32 to JAX bf16 {yardstick:.3e}, "
              f"ratio {port_gap / yardstick:.3f}")
        # bf16 rounding must show at all, or the yardstick measures nothing.
        assert yardstick > 1e-4
        assert port_gap <= 2.0 * yardstick
