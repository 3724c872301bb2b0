"""Public-key deserialization LRU + incremental aggregation cache.

Reference parity: crates/bls-crypto/src/bls/cache.rs —
  - LRU(512) keyed on serialized bytes (cache.rs:14-22,49-61)
  - incremental aggregate: keep the current validator-key set and running
    sum; on change, add the new keys and subtract the removed ones
    (cache.rs:63-88).
"""

from collections import OrderedDict

from ..hostmath import curves
from .keys import PublicKey


class PublicKeyCache:
    CACHE_SIZE = 512

    def __init__(self):
        self.keys = set()           # frozenset of current serialized keys
        self.aggregated = PublicKey(None)
        self.de = OrderedDict()     # bytes -> PublicKey (LRU)

    def clear_cache(self):
        self.keys = set()
        self.aggregated = PublicKey(None)
        self.de = OrderedDict()

    def deserialize(self, data: bytes) -> PublicKey:
        """LRU-cached compressed deserialization (cache.rs:49-61)."""
        key = bytes(data)
        if key in self.de:
            self.de.move_to_end(key)
            return self.de[key]
        pk = PublicKey.from_bytes(key)
        self.de[key] = pk
        if len(self.de) > self.CACHE_SIZE:
            self.de.popitem(last=False)
        return pk

    def aggregate(self, public_keys) -> PublicKey:
        """Incremental aggregation over a slowly-changing key set
        (cache.rs:63-88). Keys are identified by their G2 point value."""
        new_keys = {pk.pt for pk in public_keys}
        added = new_keys - self.keys
        removed = self.keys - new_keys
        acc = self.aggregated.pt
        for pt in added:
            acc = curves.G2.add(acc, pt)
        for pt in removed:
            acc = curves.G2.add(acc, curves.G2.neg(pt))
        self.keys = new_keys
        self.aggregated = PublicKey(acc)
        return self.aggregated
