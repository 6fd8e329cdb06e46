"""Model zoo of the port (the BERT family so far)."""
