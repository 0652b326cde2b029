"""The benchmark's plain float32 reference of the system under test: the ViT
encoder and predictor (``vit.py``), attention in blocks (``attention.py``) and
the train step (``train.py``). It imports nothing of the program."""
