"""Host-side analyses whose results the documentation quotes."""
