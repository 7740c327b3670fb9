"""Frozen DAMSM text encoder: bidirectional LSTM/GRU over captions.

Counterpart of ``eegan_tpu/models/text_encoder.py`` (reference
`RNN_ENCODER`, `DAMSM.py:30-115`). The JAX package rebuilds torch's
``pack_padded_sequence(enforce_sorted=False)`` semantics with masked scans;
here the packed ``nn.LSTM`` / ``nn.GRU`` is used directly (cuDNN stands
where XLA stood):

* per-timestep outputs are exact zeros for t >= length,
* the forward final state is taken at t = length-1 of each sample,
* the backward direction starts at t = length-1 and ends at t = 0.

Keys are the reference's (``encoder.weight``, ``rnn.weight_ih_l0``,
``rnn.weight_ih_l0_reverse``...). The encoder is frozen and runs in float32
under every COMPUTE_DTYPE (the JAX package casts it to the compute dtype).

Returned shapes (time-minor, as the JAX package's):
    words_emb: (B, T, D_total)   zeros at padded steps
    sent_emb:  (B, D_total)      concat of final fwd/bwd states
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


class TextEncoder(nn.Module):
    def __init__(self, ntoken: int, ninput: int = 300, nhidden: int = 256,
                 rnn_type: str = "LSTM", drop_prob: float = 0.5,
                 bidirectional: bool = True):
        super().__init__()
        if rnn_type not in ("LSTM", "GRU"):
            raise NotImplementedError(rnn_type)
        self.rnn_type = rnn_type
        self.num_directions = 2 if bidirectional else 1
        self.encoder = nn.Embedding(ntoken, ninput)
        nn.init.uniform_(self.encoder.weight, -0.1, 0.1)
        self.drop = nn.Dropout(drop_prob)
        rnn_cls = nn.LSTM if rnn_type == "LSTM" else nn.GRU
        self.rnn = rnn_cls(ninput, nhidden // self.num_directions, 1,
                           batch_first=True, bidirectional=bidirectional)

    def forward(self, captions, cap_lens, generator=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """captions: (B, T) ints; cap_lens: (B,) ints in [1, T] (any device;
        packing reads them on the host). In train mode the embeddings take
        dropout, its mask drawn from ``generator`` (a ``torch.Generator`` on
        the captions' device; the global RNG when None)."""
        b, t = captions.shape
        emb = self.encoder(captions.long())
        p = self.drop.p
        if self.training and p > 0:
            keep = torch.rand(emb.shape, generator=generator,
                              device=emb.device) >= p
            emb = emb * keep / (1.0 - p)
        lens = torch.as_tensor(cap_lens).to("cpu", torch.int64)
        packed = pack_padded_sequence(emb, lens, batch_first=True,
                                      enforce_sorted=False)
        out, hidden = self.rnn(packed)
        h_n = hidden[0] if self.rnn_type == "LSTM" else hidden
        words = pad_packed_sequence(out, batch_first=True, total_length=t)[0]
        sent = h_n.transpose(0, 1).reshape(b, -1)
        return words, sent
