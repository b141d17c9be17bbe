"""The schemes (so far TFHE)."""
