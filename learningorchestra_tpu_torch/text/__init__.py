"""Text preprocessing of the port — port of ``learningorchestra_tpu/text/``:
the BPE tokenizer behind the ``/transform/text`` service, which turns a
raw-text column into a sharded dataset of fixed-length int32 token rows
that the streaming fit reads."""

from learningorchestra_tpu_torch.text.bpe import BpeTokenizer

__all__ = ["BpeTokenizer"]
