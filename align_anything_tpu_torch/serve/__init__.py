"""Serving: the OpenAI-compatible HTTP server over the continuous engine
(``api_server.py``), the port of ``align_anything_tpu/serve``.  The gradio
command-line front ends are not ported yet (ROADMAP §1 item 15)."""
