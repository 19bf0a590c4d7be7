"""Host models (``keccak``, ``secp256k1``), bucket rounding and the batched
verifier facade (``verifier``)."""
