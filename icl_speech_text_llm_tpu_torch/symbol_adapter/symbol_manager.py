"""Symbol manager: label→random-symbol mappings for ICL research.

A copy of ``icl_speech_text_llm_tpu/symbol_adapter/symbol_manager.py``: the
same draws from ``random.Random(seed)`` in the same order, so a seed gives
the same symbols (and the trainer's masked subsets, drawn from ``_rng``)
in both packages. Behavioral parity with the reference SymbolManager
(ref: models/symbolAdapter/symbol_manager.py:13-312): fixed vs per-epoch
dynamic mappings, 2-token symbol generation, batch prompt/completion
replacement with optional random masking (~1/8 of labels), case-insensitive
reverse conversion, JSON persistence.
"""

from __future__ import annotations

import json
import logging
import random
import re
import string
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


class SymbolManager:
    def __init__(
        self,
        original_labels: List[str],
        tokenizer,
        dynamic_per_epoch: bool = False,
        symbol_type: str = "two_token",
        seed: Optional[int] = None,
    ):
        self.original_labels = list(original_labels)
        self.tokenizer = tokenizer
        self.dynamic_per_epoch = dynamic_per_epoch
        self.symbol_type = symbol_type
        self._rng = random.Random(seed)

        self.fixed_mappings: Dict[str, str] = {}
        self.epoch_mappings_history: Dict[int, Dict[str, str]] = {}
        self.current_epoch = 0

        if not self.dynamic_per_epoch:
            self.fixed_mappings = self._generate_symbol_mappings()
            self.list_of_symbols = list(self.fixed_mappings.values())
            logger.info(f"Generated fixed symbol mappings: {self.fixed_mappings}")

    # -- generation ------------------------------------------------------
    def _generate_symbol_mappings(self) -> Dict[str, str]:
        if self.symbol_type != "two_token":
            raise ValueError(f"Unsupported symbol type: {self.symbol_type}")
        symbols = self._generate_two_token_symbols(len(self.original_labels))
        return dict(zip(self.original_labels, symbols))

    def _generate_two_token_symbols(self, num_symbols: int) -> List[str]:
        """Random 4-5 char lowercase words that tokenize to exactly 2 tokens
        and round-trip decode (ref :126-159)."""
        chars = string.ascii_lowercase
        words: List[str] = []
        used = set()
        attempts = 0
        while len(words) < num_symbols and attempts < 10_000:
            attempts += 1
            word = "".join(self._rng.choice(chars) for _ in range(self._rng.choice([4, 5])))
            if word in used:
                continue
            used.add(word)
            try:
                ids = self.tokenizer.encode(word, add_special_tokens=False)
                if len(ids) == 2:
                    decoded = self.tokenizer.decode(ids, skip_special_tokens=True).strip()
                    if decoded.lower() == word.lower():
                        words.append(word)
            except Exception:
                continue
        if len(words) < num_symbols:
            logger.warning(f"Could only generate {len(words)} symbols, needed {num_symbols}")
        return words[:num_symbols]

    # -- accessors -------------------------------------------------------
    def get_symbols_for_epoch(self, epoch: int, force_new_symbols: bool = False) -> Dict[str, str]:
        if not self.dynamic_per_epoch:
            return self.fixed_mappings
        if force_new_symbols or epoch not in self.epoch_mappings_history:
            logger.info(f"Generating NEW symbols for epoch {epoch} (force={force_new_symbols})")
            self.epoch_mappings_history[epoch] = self._generate_symbol_mappings()
        self.current_epoch = epoch
        return self.epoch_mappings_history[epoch]

    def get_current_symbols(self) -> Dict[str, str]:
        if not self.dynamic_per_epoch:
            return self.fixed_mappings
        return self.epoch_mappings_history.get(self.current_epoch, {})

    def get_reverse_mappings(
        self, epoch: Optional[int] = None, mappings: Optional[Dict[str, str]] = None
    ) -> Dict[str, str]:
        if mappings is None:
            mappings = (
                self.get_symbols_for_epoch(epoch) if epoch is not None
                else self.get_current_symbols()
            )
        reverse: Dict[str, str] = {}
        for original, symbol in mappings.items():
            reverse[symbol.lower()] = original
            reverse[symbol] = original
        return reverse

    def get_symbol_tokens(self, epoch: Optional[int] = None) -> List[str]:
        mappings = (
            self.get_symbols_for_epoch(epoch) if epoch is not None
            else self.get_current_symbols()
        )
        return list(mappings.values())

    # -- batch ops -------------------------------------------------------
    def replace_symbols_in_batch(
        self,
        batch: Dict[str, Any],
        epoch: Optional[int] = None,
        mappings: Optional[Dict[str, str]] = None,
        random_mask: bool = False,
        force_new_symbols: bool = False,
    ) -> Dict[str, Any]:
        """Replace labels with symbols in 'prompt'/'completion' lists
        (ref :161-223). random_mask masks only ⌈n/8⌉ labels per call."""
        if mappings is not None:
            symbol_mappings = mappings
        elif epoch is not None:
            symbol_mappings = self.get_symbols_for_epoch(epoch, force_new_symbols)
        else:
            symbol_mappings = self.get_current_symbols()
        if not symbol_mappings:
            return batch

        if random_mask:
            num_to_mask = max(1, len(symbol_mappings) // 8)
            masked = set(self._rng.sample(list(symbol_mappings.keys()), num_to_mask))
        else:
            masked = set(symbol_mappings.keys())

        updated = dict(batch)
        for key in ("prompt", "completion"):
            if key in batch:
                out = []
                for text in batch[key]:
                    for original, symbol in symbol_mappings.items():
                        if original in masked:
                            text = text.replace(original, symbol)
                    out.append(text)
                updated[key] = out
        return updated

    def convert_symbols_back(
        self,
        text: str,
        epoch: Optional[int] = None,
        mappings: Optional[Dict[str, str]] = None,
    ) -> str:
        """Symbols → original labels, case-insensitive fallback (ref :225-259)."""
        if mappings is not None:
            reverse = self.get_reverse_mappings(mappings=mappings)
        elif epoch is not None:
            reverse = self.get_reverse_mappings(epoch)
        else:
            reverse = self.get_reverse_mappings()
        if not reverse:
            return text
        converted = text
        for symbol, original in reverse.items():
            if symbol in converted:
                converted = converted.replace(symbol, original)
            elif symbol.lower() in converted.lower():
                pattern = re.compile(re.escape(symbol), re.IGNORECASE)
                if pattern.search(converted):
                    converted = pattern.sub(original, converted)
        return converted

    # -- persistence -----------------------------------------------------
    def save_mappings(self, filepath: str) -> None:
        data = {
            "original_labels": self.original_labels,
            "dynamic_per_epoch": self.dynamic_per_epoch,
            "symbol_type": self.symbol_type,
            "fixed_mappings": self.fixed_mappings,
            "epoch_mappings_history": self.epoch_mappings_history,
            "current_epoch": self.current_epoch,
        }
        with open(filepath, "w") as f:
            json.dump(data, f, indent=2)
        logger.info(f"Saved symbol mappings to {filepath}")

    def load_mappings(self, filepath: str) -> None:
        with open(filepath) as f:
            data = json.load(f)
        self.original_labels = data["original_labels"]
        self.dynamic_per_epoch = data["dynamic_per_epoch"]
        self.symbol_type = data["symbol_type"]
        self.fixed_mappings = data["fixed_mappings"]
        self.epoch_mappings_history = {
            int(k): v for k, v in data["epoch_mappings_history"].items()
        }
        self.current_epoch = data["current_epoch"]

    def __str__(self) -> str:
        mode = "Dynamic" if self.dynamic_per_epoch else "Fixed"
        return (
            f"SymbolManager({mode}, {len(self.get_current_symbols())} mappings, "
            f"epoch={self.current_epoch})"
        )
