"""The schemes: TFHE, FHEW (single- and multi-key), CKKS with its bootstrap,
and BGV."""
