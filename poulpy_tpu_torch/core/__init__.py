"""Ciphertext layouts, encryption, external product, key switching, GLWE → LWE
conversion and decryption."""
