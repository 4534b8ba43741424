"""Host-side numpy graph builders."""
