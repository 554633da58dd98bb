"""Tools of the port: measurement tools run on the card, the writers of
small synthetic corpora (``make_mini_timit``, ``make_mini_librispeech``) and
the TIMIT acceptance protocol (``run_timit_protocol``)."""
