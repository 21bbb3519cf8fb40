"""Host codecs of the port: BQZH headers, BQZE DNA-stream decode."""
