"""Model zoo of the port: the MLPs, the text models (LSTM, BERT, the
decoder LM), the vision models and the mixture-of-experts models."""
