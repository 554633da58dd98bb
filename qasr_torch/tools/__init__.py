"""Tools of the port: measurement tools run on the card, and the writers of
small synthetic corpora (``make_mini_timit``, ``make_mini_librispeech``)."""
