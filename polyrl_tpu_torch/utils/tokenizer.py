"""Tokenizer utilities (a copy of ``polyrl_tpu/utils/tokenizer.py``).

``load_tokenizer`` resolves a HF tokenizer when ``transformers`` and local
weights are available, else falls back to ``ByteTokenizer``, a
dependency-free byte-level tokenizer for tests and synthetic-data runs.
"""

from __future__ import annotations


class ByteTokenizer:
    """UTF-8 bytes + specials: pad=256, bos=257, eos=258. Vocab 260."""

    def __init__(self):
        self.pad_token_id = 256
        self.bos_token_id = 257
        self.eos_token_id = 258
        self.vocab_size = 260

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> list[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [self.bos_token_id] + ids
        if add_eos:
            ids = ids + [self.eos_token_id]
        return ids

    _SPECIAL_NAMES = {256: "<pad>", 257: "<bos>", 258: "<eos>"}

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        if skip_special_tokens:
            bs = bytes(int(i) for i in ids if int(i) < 256)
            return bs.decode("utf-8", errors="replace")
        parts: list[str] = []
        run: list[int] = []
        for i in ids:
            i = int(i)
            if i < 256:
                run.append(i)
            else:
                if run:
                    parts.append(bytes(run).decode("utf-8", errors="replace"))
                    run = []
                parts.append(self._SPECIAL_NAMES.get(i, f"<unk{i}>"))
        if run:
            parts.append(bytes(run).decode("utf-8", errors="replace"))
        return "".join(parts)

    def batch_decode(self, seqs, skip_special_tokens: bool = True) -> list[str]:
        return [self.decode(s, skip_special_tokens) for s in seqs]

    def __call__(self, text: str, **kw):
        return {"input_ids": self.encode(text)}


def load_tokenizer(path_or_name: str):
    """HF tokenizer if resolvable, else ByteTokenizer for the synthetic path."""
    if path_or_name in ("byte", "bytes", "test"):
        return ByteTokenizer()
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(path_or_name)
        if tok.pad_token_id is None:
            tok.pad_token = tok.eos_token
        return tok
    except Exception:
        return ByteTokenizer()
