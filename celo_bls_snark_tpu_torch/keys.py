"""Re-export of bls/keys.py (reference:
crates/bls-crypto/src/bls/{secret,public}.rs), kept so that the imports of
bench.py, entry.py and the scripts stay as they were."""

from .bls import SIG_DOMAIN
from .bls.keys import PrivateKey, PublicKey

__all__ = ["PrivateKey", "PublicKey", "SIG_DOMAIN"]
