"""The plain reference the benchmark holds the port to: a frozen float32
copy of the port's two models (SD towers, implicit captioner, pixel decoder
with plain deformable attention, masked transformer decoder, CLIP head,
vocabulary heads), its set criterion with the matcher (solved exactly by
the Hungarian method), its grounding loss and its AdamW. It imports nothing
of the port, of JAX or of the JAX package, and takes no tensor the program
made but its discrete choices: its weights come from the seed
(``perfbench.common.weights``), its text embeddings from its own text
tower; where it is handed the program's thresholded masks and matcher
assignments, it follows them and checks each against its own
(``decisions.py``).
"""
